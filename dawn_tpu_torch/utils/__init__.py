"""Host utilities of the training scripts: logging and seeding."""
