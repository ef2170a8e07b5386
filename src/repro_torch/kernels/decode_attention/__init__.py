"""GQA flash-decode (dense and paged) for the ``decode_dense`` and
``decode_paged`` kernel sites."""
