"""Host-side native code of the port: the threaded .npy reader and the
mesh rasteriser."""
