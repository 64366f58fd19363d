"""The plain reference: exact RNS arithmetic in plain PyTorch, re-derived
from a configuration's primes.  It imports nothing of the program."""
