"""Plain references the served outputs are judged by; they import
nothing of the program."""
