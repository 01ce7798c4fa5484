"""CSPRNG shim for protocol randomness.

The trusted-setup trapdoor tau and the prover's ZK blinding scalars (Mixer)
must come from a cryptographically secure source — the reference uses
`thread_rng()` / ICICLE `generate_random` (OS-entropy backed).  This shim
exposes the tiny `.bytes(n)` surface our Tau.random / Mixer.random expect,
backed by os.urandom.  Tests keep passing `np.random.default_rng(seed)` for
reproducibility; production paths (cli.py) use `secure_rng()`.
"""

from __future__ import annotations

import os


class SystemRNG:
    """os.urandom-backed generator with the numpy-Generator `.bytes` API."""

    @staticmethod
    def bytes(n: int) -> bytes:
        return os.urandom(n)


def secure_rng() -> SystemRNG:
    return SystemRNG()
