"""The benchmark's own tests, on the CPU."""
