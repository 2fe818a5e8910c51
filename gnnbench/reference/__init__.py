"""The plain reference the benchmark judges the program by: PyTorch only,
float32 with TF32 off; it imports nothing of the program."""
