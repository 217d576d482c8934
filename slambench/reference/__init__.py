"""Plain references that decide ``correct``: torch and NumPy only,
nothing of the program."""
