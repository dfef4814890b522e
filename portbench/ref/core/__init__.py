"""Field, hash, NTT and Merkle layers of the port (see the package docstring)."""
