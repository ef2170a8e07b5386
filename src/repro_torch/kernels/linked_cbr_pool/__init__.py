"""Linked CBR-AvgPool (the paper's ``cbra`` op) for the ``linked_matmul``
kernel site."""
