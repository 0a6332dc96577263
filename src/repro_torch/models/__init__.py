"""Dense decoder-family model and sparse deployment containers."""
