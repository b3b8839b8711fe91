"""The plain reference: the paper's scheme and its manufactured solutions
in plain torch and SymPy, importing nothing of the program."""
