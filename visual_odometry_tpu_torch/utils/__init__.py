"""Config, I/O, evaluation and synthetic data of the port."""
