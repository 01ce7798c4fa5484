"""Circom witness calculator over the wasm_vm translator.

Python equivalent of the reference's `witness_calculator.js` protocol
(`qap-compiler/subcircuits/library/witness_calculator.js`): instantiate a
subcircuit module, feed named input signals through the shared RW memory
(32-bit word at a time, FNV-hashed signal names), run the generated
calculator, and read back the full witness.  The synthesizer layer calls
this per placement exactly like `variableGenerator.ts:356` calls
`calculateWitness({in: values}, 0)`.
"""

from __future__ import annotations

import functools
import os

from .wasm_vm import Instance, WasmError


class WitnessCalcError(RuntimeError):
    pass


_EXC_MESSAGES = {
    1: "Signal not found.",
    2: "Too many signals set.",
    3: "Signal already set.",
    4: "Assert Failed.",
    5: "Not enough memory.",
    6: "Input signal array access exceeds the size.",
}


def _fnv1a_64(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s:
        h = ((h ^ ord(ch)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class WitnessCalculator:
    """One instantiated subcircuit witness calculator (reusable)."""

    def __init__(self, code: bytes):
        self._err: list[str] = []

        def exception_handler(code_):
            msg = _EXC_MESSAGES.get(code_, "Unknown error.")
            raise WitnessCalcError(msg + " " + " ".join(self._err))

        def print_error_message():
            self._err.append(self._get_message())

        def noop(*_a):
            return None

        self.inst = Instance(
            code,
            {
                "runtime": {
                    "exceptionHandler": exception_handler,
                    "printErrorMessage": print_error_message,
                    "writeBufferMessage": noop,
                    "showSharedRWMemory": noop,
                }
            },
        )
        ex = self.inst.exports
        self.n32 = ex["getFieldNumLen32"]()
        ex["getRawPrime"]()
        self.prime = self._read_fr()
        self.witness_size = ex["getWitnessSize"]()
        self.version = ex["getVersion"]()

    def _get_message(self) -> str:
        out = []
        gc = self.inst.exports["getMessageChar"]
        c = gc()
        while c:
            out.append(chr(c))
            c = gc()
        return "".join(out)

    def _read_fr(self) -> int:
        rd = self.inst.exports["readSharedRWMemory"]
        v = 0
        for j in range(self.n32 - 1, -1, -1):
            v = (v << 32) | rd(j)
        return v

    def _write_fr(self, v: int):
        wr = self.inst.exports["writeSharedRWMemory"]
        for j in range(self.n32):
            wr(j, v & 0xFFFFFFFF)
            v >>= 32

    def calculate_witness(self, inputs: dict, sanity_check: int = 0) -> list[int]:
        """inputs: {signal_name: int | list[int]} -> witness list of ints."""
        ex = self.inst.exports
        ex["init"](sanity_check)
        count = 0
        for name, vals in inputs.items():
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            h = _fnv1a_64(name)
            h_msb, h_lsb = h >> 32, h & 0xFFFFFFFF
            size = ex["getInputSignalSize"](h_msb, h_lsb)
            if size < 0 or size >= 1 << 31:
                raise WitnessCalcError(f"signal {name} not found")
            if len(vals) != size:
                raise WitnessCalcError(
                    f"signal {name}: got {len(vals)} values, circuit wants {size}"
                )
            for i, v in enumerate(vals):
                self._write_fr(int(v) % self.prime)
                ex["setInputSignal"](h_msb, h_lsb, i)
                count += 1
        if count < ex["getInputSize"]():
            raise WitnessCalcError(
                f"only {count} of {ex['getInputSize']()} inputs set"
            )
        out = []
        for i in range(self.witness_size):
            ex["getWitness"](i)
            out.append(self._read_fr())
        return out


@functools.lru_cache(maxsize=None)
def _load_translated(path: str, mtime: float):
    with open(path, "rb") as f:
        return f.read()


class SubcircuitCalculators:
    """Lazy per-subcircuit calculators over a library's wasm/ directory.

    NOTE: a WitnessCalculator instance is stateful (memory persists across
    calls, reset by init()); one instance per subcircuit is reused for all
    placements, matching the reference's per-subcircuit calculator reuse
    (`variableGenerator.ts:33,88`).
    """

    def __init__(self, library_dir: str):
        self.wasm_dir = os.path.join(library_dir, "wasm")
        self._calcs: dict[int, WitnessCalculator] = {}
        self.library_dir = library_dir
        # compiled-R1CS fast path (frontend/r1cs_eval.py), far faster than
        # the WASM translator; None = not yet tried, False = uncompilable
        # (WASM fallback)
        self._compiled: dict[int, object] = {}
        self._lib_cache = None

    def available(self) -> bool:
        return os.path.isdir(self.wasm_dir)

    def _compiled_for(self, subcircuit_id: int):
        ce = self._compiled.get(subcircuit_id)
        if ce is None:
            from ..io.artifacts import load_library
            from .r1cs_eval import UncompilableR1CS, compile_subcircuit

            if self._lib_cache is None:
                self._lib_cache = load_library(self.library_dir)
            _, infos, r1cs = self._lib_cache
            info = next(i for i in infos if i.id == subcircuit_id)
            try:
                ce = compile_subcircuit(r1cs[subcircuit_id], info)
            except UncompilableR1CS:
                ce = False
            self._compiled[subcircuit_id] = ce
        return ce

    def get(self, subcircuit_id: int) -> WitnessCalculator:
        c = self._calcs.get(subcircuit_id)
        if c is None:
            path = os.path.join(self.wasm_dir, f"subcircuit{subcircuit_id}.wasm")
            if not os.path.exists(path):
                raise WasmError(f"no wasm module at {path}")
            with open(path, "rb") as f:
                c = WitnessCalculator(f.read())
            self._calcs[subcircuit_id] = c
        return c

    def witness(self, subcircuit_id: int, in_values: list[int]) -> list[int]:
        """Witness for one placement: `{in: values}` like the reference —
        via the compiled-R1CS evaluator when the subcircuit compiles
        (bit-exact against the WASM calculator), else the
        WASM calculator."""
        ce = self._compiled_for(subcircuit_id)
        if ce is not False:
            from .r1cs_eval import UncompilableR1CS

            try:
                return ce.evaluate(in_values)
            except UncompilableR1CS:
                pass
        return self.get(subcircuit_id).calculate_witness({"in": in_values})


def poseidon2_from_calcs(calcs: "SubcircuitCalculators", pos_info):
    """Poseidon255(a, b) via the shipped Poseidon calculator (selector=1 =
    chain length 1, `Poseidon_circuit.circom`) — the host hash used for the
    storage Merkle trees (frontend/merkle.py)."""
    L128 = (1 << 128) - 1

    def pose2(a: int, b: int) -> int:
        ins = [1, a & L128, a >> 128, b & L128, b >> 128]
        ins += [0] * (pos_info.In_idx[1] - len(ins))
        w = calcs.witness(pos_info.id, ins)
        o0 = pos_info.Out_idx[0]
        return w[o0] | (w[o0 + 1] << 128)

    return pose2
