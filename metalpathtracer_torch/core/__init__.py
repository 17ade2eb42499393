"""Vector math and the counter-based RNG, on torch tensors."""
