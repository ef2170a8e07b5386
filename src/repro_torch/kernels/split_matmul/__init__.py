"""DOS parameter-split matmul (§4.2.2) for the ``split_matmul`` kernel
site."""
