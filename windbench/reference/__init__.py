"""The plain reference the benchmark holds the program to (plain PyTorch,
float32 with TF32 off; nothing of the program, of JAX or of the JAX
package is imported here)."""
