"""Plain references the cells are held to; they import nothing of the program."""
