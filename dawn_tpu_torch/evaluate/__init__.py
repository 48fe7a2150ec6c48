"""Scoring what the model makes: the ACTOR metric suite and its LaTeX tables,
the STGCN recognizer's feature space, I3D FVD, the LFG-feature Frechet and
the lip-sync and AV-sync proxies, and the LFG reconstruction test."""
