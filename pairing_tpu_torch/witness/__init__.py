"""Witness generation, serialization, and independent replay checking.

  trace.pairing_witness        batched pairing_circuit semantics
  trace.fq12_exp_u64           starky fq12_exp_u64_circuit (C12) shape
  stream.witness_stream        chunked witnesses, copy-out overlapping compute
  serialize.save_pairing_witness / load_pairing_witness   npz format
  verify.verify_pairing_witness  the `connect` analogue (replay checker)
  constraints.check_pairing_constraints  limb-level AIR identity checker

The two checkers are copies of the reference's numpy-only modules, so they
read files written by either package.
"""

from .constraints import ConstraintError, check_pairing_constraints
from .serialize import load_pairing_witness, save_pairing_witness
from .trace import multi_pairing_witness, pairing_witness
from .verify import WitnessError, verify_pairing_witness
