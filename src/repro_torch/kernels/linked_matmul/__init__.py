"""Linked Matmul->Matmul (the SwiGLU MLP) for the ``linked_matmul`` kernel
site."""
