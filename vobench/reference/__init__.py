"""The plain reference the benchmark holds the program's outputs to
(``vo.track``). Plain PyTorch, no kernels; it imports nothing of the program
and takes nothing the program made: it reads the pool the benchmark made and
works out every stage again."""
