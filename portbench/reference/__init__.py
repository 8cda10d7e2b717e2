"""The plain reference: the benchmark's CSR arrays as a torch operator, the
numbers that judge each answer, and a plain BiCGSTAB that stands in the
program's place as the lower-precision control.  Plain PyTorch and NumPy:
nothing here imports the program or the JAX package, or takes anything the
program made."""
