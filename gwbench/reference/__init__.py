"""The plain reference the benchmark holds the program against: plain
PyTorch over the generated inputs, importing nothing of the program."""
