"""Plain float32 references, one module per configuration family; none imports the program."""
