"""The plain reference the benchmark holds the program to (`kmers`) and
the control system that breaks one guarantee of the configuration
(`control`).  Nothing here imports the program."""
