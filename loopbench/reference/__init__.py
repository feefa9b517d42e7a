"""The plain references the benchmark holds the program to: plain torch or
numpy, importing nothing of the program."""
