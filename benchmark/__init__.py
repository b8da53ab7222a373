"""The benchmark of foldingdiff_tpu_torch on the card (see README.md)."""
