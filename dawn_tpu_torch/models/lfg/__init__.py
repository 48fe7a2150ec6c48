"""LFG flow-warping generator (inference side)."""
