"""The SNARK layer's host side: the circuit builder and its gates, the
verifier and the recursion gadget (copies of the port's ``snark/``
modules; the prover is the program's and is not copied). Constants and
sigmas are committed with the plain LDE and Merkle tree of ``core/``.
"""

from .config import CircuitConfig
from .circuit import CircuitBuilder
