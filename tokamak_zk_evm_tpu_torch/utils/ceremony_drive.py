"""The MPC ceremony at the synthetic full shape, driven as a user would on
the card: in process with seeded rngs (`drive_ceremony`) and through the
CLI's files (`drive_ceremony_files`).  Every step is checked as it runs (a
failed check raises `CheckFailed`) and timed on the host clock, each step
ending in a synchronize.  `chip_smoke.py` phase 5e and `utils/bench_ceremony.py`
run these; scratch files go under the checkout's `.cache/` and are deleted
at the end.
"""

from __future__ import annotations

import contextlib
import os
import time

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     ".cache")


class CheckFailed(RuntimeError):
    """A ceremony step's result is wrong."""


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    log(f"  ok  {what}")


def synthetic_fixture():
    from tokamak_zk_evm_tpu_torch.testing.synthetic import build_synthetic

    t0 = time.perf_counter()
    fx = build_synthetic()
    p = fx.params
    log(f"  fixture n={p.n} s_max={p.s_max} m_i={p.m_i} m_D={p.m_D} "
        f"placements={len(fx.placements)} built in {time.perf_counter() - t0:.3f} s (host)")
    return fx



def sigma_equal(torch, a, b) -> bool:
    """Every device family byte-equal and every host point equal."""
    s1, t1 = a.sigma_1, b.sigma_1
    for name in ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
                 "delta_inv_li_o_prv"):
        if not all(torch.equal(u, v) for u, v in zip(getattr(s1, name), getattr(t1, name))):
            return False
    host = ("x", "y", "delta", "eta", "delta_inv_alphak_xh_tx", "delta_inv_alpha4_xj_tx",
            "delta_inv_alphak_yi_ty", "h_max", "rs_y")
    return (all(getattr(s1, k) == getattr(t1, k) for k in host)
            and (a.G, a.H, a.lagrange_KL, a.sigma_2) == (b.G, b.H, b.lagrange_KL, b.sigma_2))



class SeqRng:
    """Seeded bytes: the ceremony's rng, so that its secrets can be replayed."""

    def __init__(self, np, seed):
        self._rng = np.random.default_rng(seed)

    def bytes(self, n):
        return self._rng.bytes(n)


def family_points(sigma) -> int:
    return sum(int(getattr(sigma.sigma_1, f)[2].numel()) for f in
               ("xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
                "delta_inv_li_o_prv"))


def drive_ceremony(torch, np, dev, fx, b13=None):
    """Phase 5e, in process: the ceremony of `tests/test_mpc_setup.py`'s end
    gate at the synthetic full shape on the card (seeded rngs: the secrets
    are replayed from a second copy of each), every step verified; the
    result against `generate_sigma` for the combined secrets; two tampered
    Sigmas rejected.  -> seconds by stage.  With `b13` ({"events": the list
    `recording` fills, "steps": {}}), each stage's B13 device seconds go
    into b13["steps"]."""
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch.fields import R_MOD
    from tokamak_zk_evm_tpu_torch.host.curve import G1
    from tokamak_zk_evm_tpu_torch.models import mpc_setup as M
    from tokamak_zk_evm_tpu_torch.models.setup import Tau, generate_sigma
    from tokamak_zk_evm_tpu_torch.ops import field as F

    p, t = fx.params, {}

    def timed(name, fn):
        lo = len(b13["events"]) if b13 else 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        if b13:
            b13["steps"][name] = b13_seconds(b13["events"], lo)
        return out

    acc = M.Phase1Accumulator.initial(p)
    rng, shadow = SeqRng(np, 7), SeqRng(np, 7)
    alpha = x = 1
    for i in (1, 2):
        new, proof = timed(f"phase1_compute_{i}", lambda: acc.compute(rng, dev))
        ok = timed(f"phase1_verify_{i}",
                   lambda: acc.verify(new, proof, np.random.default_rng(100 + i), dev))
        expect(ok is True, f"phase-1 contribution {i} ({len(new.x_g1)} + 4 + 4 x "
               f"{new.ax_len} G1 powers) verifies")
        a_u, x_u = M._rand_fr(shadow), M._rand_fr(shadow)
        M._rand_fr(shadow), M._rand_fr(shadow)  # the two Schnorr nonces
        alpha, x = alpha * a_u % R_MOD, x * x_u % R_MOD
        acc = new
    os.makedirs(CACHE, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ceremony_", dir=CACHE)
    try:
        path = os.path.join(tmp, "acc.json")
        timed("phase1_json_save", lambda: acc.save(path))
        loaded = timed("phase1_json_load_checked", lambda: M.Phase1Accumulator.load(path, dev))
        expect(loaded.hash() == acc.hash(), f"phase-1 JSON ({os.path.getsize(path)} B) read "
               f"back through the checked load keeps the hash chain")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    y = 0x1234567
    sigma = timed("phase2_prepare", lambda: M.phase2_prepare(acc, y, p, fx.library, fx.infos,
                                                             dev))
    rng, shadow = SeqRng(np, 9), SeqRng(np, 9)
    gamma = delta = eta = 1
    for i in (1, 2):
        prev = sigma
        sigma, proof = timed(f"phase2_contribute_{i}", lambda: M.phase2_contribute(prev, rng))
        ok = timed(f"phase2_verify_{i}",
                   lambda: M.phase2_verify(prev, sigma, proof, np.random.default_rng(200 + i)))
        expect(ok is True, f"phase-2 contribution {i} verifies")
        g_u, d_u, e_u = (M._rand_fr(shadow) for _ in range(3))
        for _ in range(3):  # the Schnorr nonces
            M._rand_fr(shadow)
        gamma, delta, eta = gamma * g_u % R_MOD, delta * d_u % R_MOD, eta * e_u % R_MOD

    tau = Tau(x=x, y=y, alpha=alpha, gamma=gamma, delta=delta, eta=eta)
    want = timed("generate_sigma", lambda: generate_sigma(p, tau, fx.library, fx.infos,
                                                          device=dev))
    expect(sigma_equal(torch, sigma, want),
           f"ceremony Sigma == generate_sigma(Tau(x, y, alpha, gamma, delta, eta)) on all "
           f"{family_points(sigma)} family points and every host point")
    del want

    import dataclasses

    prv = [c.clone() for c in sigma.sigma_1.delta_inv_li_o_prv]
    k = int(torch.nonzero(prv[2] == 0)[0])
    gen = F.tensor(F.pack_fq([G1.gen[0], G1.gen[1]]), dev)
    prv[0][:, k], prv[1][:, k] = gen[:, 0], gen[:, 1]
    bad = dataclasses.replace(sigma, sigma_1=dataclasses.replace(
        sigma.sigma_1, delta_inv_li_o_prv=tuple(prv)))
    ok = timed("phase2_verify_tampered_prv", lambda: M.phase2_verify(
        prev, bad, proof, np.random.default_rng(300)))
    expect(ok is False, f"phase2_verify rejects delta_inv_li_o_prv with point {k} set to G")
    xy = [c.clone() for c in sigma.sigma_1.xy_powers]
    for c in xy:
        c[..., [0, 1]] = c[..., [1, 0]]
    bad = dataclasses.replace(sigma, sigma_1=dataclasses.replace(
        sigma.sigma_1, xy_powers=tuple(xy)))
    ok = timed("phase2_verify_tampered_xy", lambda: M.phase2_verify(
        prev, bad, proof, np.random.default_rng(301)))
    expect(ok is False, "phase2_verify rejects xy_powers with rows 0 and 1 swapped")
    del prv, xy, bad, sigma, prev
    torch.cuda.empty_cache()
    return t


def drive_ceremony_files(torch, dev, fx, b13=None):
    """Phase 5e through files: the port's CLI in this process, `mpc`
    phase1-init, phase1-contribute, phase1-verify (true), phase2-prepare,
    phase2-contribute (one contributor a phase, secure rng), then
    preprocess, prove --deterministic and verify (true) on the ceremony's
    CRS, in a scratch directory under the checkout's `.cache/`, deleted at
    the end.  -> seconds by stage; `b13` as for `drive_ceremony`."""
    import io
    import shutil
    import tempfile

    from tokamak_zk_evm_tpu_torch import cli
    from tokamak_zk_evm_tpu_torch.io import artifacts as art

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--device", str(dev)] + argv)
        lines = out.getvalue().strip().splitlines()
        return rc, lines[-1] if lines else ""

    os.makedirs(CACHE, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ceremony_", dir=CACHE)
    t = {}
    try:
        lib, synth = os.path.join(tmp, "library"), os.path.join(tmp, "synthesizer")
        f = lambda name: os.path.join(tmp, name)  # noqa: E731
        os.makedirs(synth)
        art.save_library(lib, fx.params, fx.infos, fx.library)
        art.save_placement_variables(fx.placements, os.path.join(synth, "placementVariables.json"))
        art.save_instance(fx.instance, os.path.join(synth, "instance.json"))
        art.save_permutation(fx.permutation, os.path.join(synth, "permutation.json"))
        stages = (
            ("mpc phase1-init", ["mpc", "phase1-init", "--library", lib, "--output", f("acc0.json")]),
            ("mpc phase1-contribute", ["mpc", "phase1-contribute", "--acc", f("acc0.json"),
                                       "--output", f("acc1.json"), "--proof", f("p1.json")]),
            ("mpc phase1-verify", ["mpc", "phase1-verify", "--prev", f("acc0.json"), "--cur",
                                   f("acc1.json"), "--proof", f("p1.json")]),
            ("mpc phase2-prepare", ["mpc", "phase2-prepare", "--library", lib, "--acc",
                                    f("acc1.json"), "--y-hex", "1234567", "--output", f("crs0")]),
            ("mpc phase2-contribute", ["mpc", "phase2-contribute", "--crs", f("crs0"),
                                       "--output", f("crs1")]),
            ("preprocess", ["preprocess", "--crs", f("crs1"), "--library", lib,
                            "--synthesizer", synth, "--output", f("pre")]),
            ("prove", ["prove", "--crs", f("crs1"), "--library", lib, "--synthesizer", synth,
                       "--output", f("proof"), "--deterministic"]),
            ("verify", ["verify", "--crs", f("crs1"), "--library", lib, "--preprocess", f("pre"),
                        "--proof", f("proof"), "--synthesizer", synth]),
        )
        rcs = {}
        for name, argv in stages:
            lo = len(b13["events"]) if b13 else 0
            t0 = time.perf_counter()
            rcs[name] = run(argv)
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
            if b13:
                b13["steps"][name] = b13_seconds(b13["events"], lo)
        log(f"  phase-1 JSON: {os.path.getsize(f('acc1.json'))} B; ceremony CRS npy: "
            f"{sum(os.path.getsize(os.path.join(f('crs1'), n)) for n in os.listdir(f('crs1')))} B")
        for name in ("mpc phase1-init", "mpc phase1-contribute", "mpc phase2-prepare",
                     "mpc phase2-contribute", "preprocess", "prove"):
            expect(rcs[name][0] == 0, f"cli {name} exits 0")
        expect(rcs["mpc phase1-verify"] == (0, "true"), "cli mpc phase1-verify prints true")
        expect(rcs["verify"] == (0, "true"),
               "cli verify prints true for the proof on the ceremony's CRS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return t



def b13_seconds(events, lo=0):
    """{"g1_add": s, "g1_dbl": s}: device seconds of the B13 launches in
    events[lo:] (their events must have completed)."""
    out = {"g1_add": 0.0, "g1_dbl": 0.0}
    for op, _, s, e in events[lo:]:
        out[op] += s.elapsed_time(e) / 1e3
    return out

