"""The programs a configuration family runs, one module each."""
