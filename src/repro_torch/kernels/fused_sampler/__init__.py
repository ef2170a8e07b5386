"""Sort-free top-k/top-p support filter for the ``sampler`` kernel site."""
