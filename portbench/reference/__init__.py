"""Plain PyTorch references of what the benchmark's cells compute, in
float32 (TF32 off) or float64. They import nothing of the program and take
only the benchmark's weights and raw inputs."""
