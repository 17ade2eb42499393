"""The hand-written closest-hit kernel, its plain twin and its tables."""
