"""The plain references: frozen copies of the frames' mathematics in plain PyTorch, importing nothing of the program."""
