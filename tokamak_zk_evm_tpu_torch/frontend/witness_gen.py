"""Unified per-placement witness generation.

The reference generates each placement's full wire assignment by running the
subcircuit's circom WASM calculator (`variableGenerator.ts:33,88,356`).  This
module is the Python-native equivalent with two engines:

  * exact: the shipped WASM module run under frontend/wasm_vm (bit-exact
    circom semantics, covers all 14 subcircuits);
  * solver: models/witness_solver.py's R1CS propagation (no WASM artifact
    needed, e.g. for self-designed synthetic subcircuits).

`WitnessGenerator.witness()` prefers the exact engine whenever the library
directory ships a wasm/ module for the subcircuit, and falls back to the
solver otherwise.  Every result passes through an R1CS satisfaction check —
a wrong witness is an error, never a silent output.
"""

from __future__ import annotations

import os

from ..fields import R_MOD


class WitnessGenError(RuntimeError):
    pass


def _check_satisfaction(r1cs, witness) -> bool:
    from ..testing.real_fixture import check_r1cs_satisfaction

    return check_r1cs_satisfaction(r1cs, witness)


class WitnessGenerator:
    """Witness engine for one subcircuit library.

    Args:
      library_dir: library root (with wasm/ for the exact engine), or None.
      infos: list of SubcircuitInfo.
      library: {subcircuit_id: parsed R1CS} for the solver path + checks.
    """

    def __init__(self, library_dir, infos, library):
        self.infos = {i.id: i for i in infos}
        self.library = library
        self._calcs = None
        if library_dir is not None:
            from .witness_calculator import SubcircuitCalculators

            calcs = SubcircuitCalculators(library_dir)
            if calcs.available():
                self._calcs = calcs
        self._cache: dict = {}

    def has_exact(self, subcircuit_id: int) -> bool:
        if self._calcs is None:
            return False
        return os.path.exists(
            os.path.join(self._calcs.wasm_dir, f"subcircuit{subcircuit_id}.wasm")
        )

    def witness(self, subcircuit_id: int, in_values, out_values=None,
                check: bool = True) -> list[int]:
        """Full wire assignment for one placement.

        in_values: the placement's input wire values (the `in` signal).
        out_values: known output values (EVM semantics from the synthesizer);
          used to seed the solver fallback and cross-checked against the
          exact engine's outputs when provided.
        """
        key = (subcircuit_id, tuple(int(v) % R_MOD for v in in_values))
        hit = self._cache.get(key)
        if hit is not None:
            return list(hit)
        info = self.infos[subcircuit_id]
        r1cs = self.library[subcircuit_id]
        if self.has_exact(subcircuit_id):
            w = self._calcs.witness(subcircuit_id, [int(v) for v in in_values])
            if out_values is not None:
                o0 = info.Out_idx[0]
                got = w[o0 : o0 + len(out_values)]
                want = [int(v) % R_MOD for v in out_values]
                if got != want:
                    raise WitnessGenError(
                        f"subcircuit {info.name}: exact-engine outputs "
                        f"{got[:4]}... disagree with expected {want[:4]}..."
                    )
        else:
            from ..models.witness_solver import solve_r1cs_witness

            known = {0: 1}
            i0 = info.In_idx[0]
            for k, v in enumerate(in_values):
                known[i0 + k] = int(v) % R_MOD
            if out_values is not None:
                o0 = info.Out_idx[0]
                for k, v in enumerate(out_values):
                    known[o0 + k] = int(v) % R_MOD
            w = solve_r1cs_witness(r1cs, info.Nwires, known)
        if check and not _check_satisfaction(r1cs, w):
            raise WitnessGenError(
                f"subcircuit {info.name}: witness fails R1CS satisfaction"
            )
        self._cache[key] = list(w)
        return w
