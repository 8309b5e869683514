"""The plain float32 reference of the benchmark's cells. It imports
neither JAX, nor the JAX package, nor the program."""
