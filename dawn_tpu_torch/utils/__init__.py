"""Host utilities of the scripts: logging, seeding and profiling."""
