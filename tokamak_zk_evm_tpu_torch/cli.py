"""The command-line pipeline over the reference's file contract.

The port of the JAX package's `cli.py`, with the same subcommands, arguments,
outputs, stderr logs and exit codes, and one option of its own, `--device`
(before the subcommand; default `cuda`, which raises without a card; the CPU
runs only when asked):

    python -m tokamak_zk_evm_tpu_torch setup      --library DIR --output DIR [--fixed-tau] [--format npz|rkyv|both]
    python -m tokamak_zk_evm_tpu_torch preprocess --crs DIR --library DIR --synthesizer DIR --output DIR
    python -m tokamak_zk_evm_tpu_torch prove      --crs DIR --library DIR --synthesizer DIR --output DIR [--deterministic] [--testing-mode]
    python -m tokamak_zk_evm_tpu_torch verify     --crs DIR --library DIR --preprocess DIR --proof DIR --synthesizer DIR
    python -m tokamak_zk_evm_tpu_torch doctor
    python -m tokamak_zk_evm_tpu_torch install    --workspace DIR [--library DIR] [--no-setup] [--fixed-tau]
    python -m tokamak_zk_evm_tpu_torch extract-proof --synthesizer DIR --preprocess DIR --prove DIR --output ZIP
    python -m tokamak_zk_evm_tpu_torch --device cpu ...

`--synthesizer DIR` holds the synthesizer outputs (`placementVariables.json`,
`instance.json`, `permutation.json`); `--library DIR` is a qap-compiler
library dir (`subcircuits/library` layout).  `verify` prints `true`/`false`
like the reference verifier.  A CRS dir written by either package is read
by the other (`io/crs.py`, `io/rkyv_crs.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _resolve_library(args) -> str:
    from .io.subcircuit_library import resolve_library_path

    return resolve_library_path(args.library)


def _device(args):
    from .utils.device import resolve_device

    return resolve_device(args.device)


def _load_synthesizer_outputs(d: str):
    from .io import artifacts as art

    placements = art.load_placement_variables(os.path.join(d, "placementVariables.json"))
    instance = art.load_instance(os.path.join(d, "instance.json"))
    permutation = art.load_permutation(os.path.join(d, "permutation.json"))
    return placements, instance, permutation


def cmd_install(args) -> int:
    """Prepare a local runtime workspace: materialize the subcircuit library,
    optionally generate the CRS locally, and record SHA-256 provenance
    digests."""
    import hashlib

    ws = args.workspace
    os.makedirs(ws, exist_ok=True)
    lib_src = _resolve_library(args)
    lib_dst = os.path.join(ws, "subcircuit-library")
    if os.path.abspath(lib_src) != os.path.abspath(lib_dst):
        import shutil

        shutil.copytree(lib_src, lib_dst, dirs_exist_ok=True)
    _log(f"[install] subcircuit library at {lib_dst}")

    digests = {}
    if not args.no_setup:
        setup_dir = os.path.join(ws, "setup")
        ns = argparse.Namespace(
            library=lib_dst, output=setup_dir, fixed_tau=args.fixed_tau,
            format="both", device=args.device,
        )
        rc = cmd_setup(ns)
        if rc:
            return rc
        for name in sorted(os.listdir(setup_dir)):
            p = os.path.join(setup_dir, name)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    digests[name] = hashlib.sha256(f.read()).hexdigest()
    prov = os.path.join(ws, "crs_provenance.json")
    with open(prov, "w") as f:
        json.dump({"artifacts": digests}, f, indent=1)
    _log(f"[install] provenance digests written to {prov}")
    return 0


def cmd_extract_proof(args) -> int:
    """Bundle the proof artifacts into one zip: instance.json,
    preprocess.json, proof.json (+ proof4_test.json when present)."""
    import zipfile

    required = [
        (args.synthesizer, "instance.json"),
        (args.preprocess, "preprocess.json"),
        (args.prove, "proof.json"),
    ]
    optional = [(args.prove, "proof4_test.json")]
    with zipfile.ZipFile(args.output, "w", zipfile.ZIP_DEFLATED) as z:
        for d, name in required:
            p = os.path.join(d, name)
            if not os.path.exists(p):
                _log(f"[extract-proof] missing required {p}")
                return 1
            z.write(p, name)
        for d, name in optional:
            p = os.path.join(d, name)
            if os.path.exists(p):
                z.write(p, name)
    _log(f"[extract-proof] bundle written to {args.output}")
    return 0


def cmd_setup(args) -> int:
    from .io import artifacts as art, crs
    from .models.setup import Tau, generate_sigma

    device = _device(args)
    params, infos, library = art.load_library(_resolve_library(args))
    if args.fixed_tau:
        tau = Tau.fixed()
    else:
        from .utils.rng import secure_rng

        tau = Tau.random(secure_rng())
    t0 = time.time()
    sigma = generate_sigma(params, tau, library, infos, device=device)
    _log(f"[setup] sigma generated in {time.time() - t0:.1f}s")
    fmt = args.format
    if fmt in ("npz", "both"):
        crs.save_sigma(sigma, args.output)
    if fmt in ("rkyv", "both"):
        from .io import rkyv_crs

        n1 = rkyv_crs.write_combined_sigma(
            sigma, params, os.path.join(args.output, "combined_sigma.rkyv")
        )
        n2 = rkyv_crs.write_sigma_preprocess(
            sigma, params, os.path.join(args.output, "sigma_preprocess.rkyv")
        )
        _log(f"[setup] rkyv archives: combined={n1}B preprocess={n2}B")
    os.makedirs(args.output, exist_ok=True)
    art.save_sigma_verify(sigma, os.path.join(args.output, "sigma_verify.json"))
    _log(f"[setup] CRS written to {args.output}")
    return 0


def cmd_preprocess(args) -> int:
    from .io import artifacts as art, crs
    from .models.preprocess import preprocess

    device = _device(args)
    # only setupParams + instance/permutation are needed here
    params = art.load_setup_params(
        os.path.join(_resolve_library(args), "setupParams.json"))
    sigma = crs.load_sigma_any(args.crs, params, device)
    instance = art.load_instance(os.path.join(args.synthesizer, "instance.json"))
    permutation = art.load_permutation(os.path.join(args.synthesizer, "permutation.json"))
    t0 = time.time()
    pre = preprocess(sigma, permutation, instance, params, device=device)
    _log(f"[preprocess] done in {time.time() - t0:.1f}s")
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, "preprocess.json")
    art.save_preprocess_solidity(pre, out)
    _log(f"[preprocess] written to {out}")
    return 0


def cmd_prove(args) -> int:
    from .io import artifacts as art, crs
    from .models.protocol import Mixer
    from .models.prover import Prover
    from .utils.rng import secure_rng

    device = _device(args)
    params, infos, library = art.load_library(_resolve_library(args))
    sigma = crs.load_sigma_any(args.crs, params, device)
    placements, instance, permutation = _load_synthesizer_outputs(args.synthesizer)
    mixer = Mixer.zero() if args.deterministic else Mixer.random(secure_rng())
    t0 = time.time()
    prover = Prover(
        params, sigma, library, infos, placements, permutation, instance,
        mixer=mixer, testing_mode=args.testing_mode, device=device,
    )
    proof, proof4t = prover.prove()
    _log(f"[prove] done in {time.time() - t0:.1f}s")
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, "proof.json")
    art.save_proof_solidity(proof, out)
    _log(f"[prove] written to {out}")
    if args.testing_mode:
        p4t_out = os.path.join(args.output, "proof4_test.json")
        art.save_proof4test(proof4t, p4t_out)
        _log(f"[prove] testing-mode components written to {p4t_out}")
    return 0


def cmd_verify(args) -> int:
    from .io import artifacts as art, crs
    from .models.verifier import Verifier

    device = _device(args)
    params = art.load_setup_params(
        os.path.join(_resolve_library(args), "setupParams.json"))
    sv = os.path.join(args.crs, "sigma_verify.json")
    if os.path.exists(sv):
        sigma = art.load_sigma_verify(sv)  # slim verifier CRS (reference contract)
    else:
        sigma = crs.load_sigma_any(args.crs, params, device)
    pre = art.load_preprocess_solidity(os.path.join(args.preprocess, "preprocess.json"))
    proof = art.load_proof_solidity(os.path.join(args.proof, "proof.json"))
    instance = art.load_instance(os.path.join(args.synthesizer, "instance.json"))
    verifier = Verifier(params, sigma, pre, instance, proof, device=device)
    ok = verifier.verify_snark()
    # decomposed testing-mode checks when the prover emitted proof4_test.json
    p4t_path = os.path.join(args.proof, "proof4_test.json")
    if os.path.exists(p4t_path):
        p4t = art.load_proof4test(p4t_path)
        for name, fn in (("arith", verifier.verify_arith),
                         ("copy", verifier.verify_copy),
                         ("binding", verifier.verify_binding)):
            res = fn(p4t)
            _log(f"[verify] decomposed {name} check: {res}")
            ok = ok and res
    print("true" if ok else "false")
    return 0 if ok else 1


def cmd_doctor(args) -> int:
    """Health check: torch, the CUDA devices, the kernel builds, and the
    field self-test (r-1)^2 == 1 through K1 on the chosen device."""
    import torch

    cuda = torch.cuda.is_available()
    names = sorted({torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())})
    _log(f"[doctor] torch {torch.__version__}; cuda {torch.version.cuda}; "
         f"devices={torch.cuda.device_count() if cuda else 0} {names}")
    from .backend import build

    _log(f"[doctor] kernels built: {json.dumps(build.built())}")
    device = _device(args)
    from .fields import R_MOD
    from .ops import field as F

    a = F.tensor(F.pack_fr([R_MOD - 1]), device)
    out = int(F.unpack_fr(F.fr_mul(a, a))[0])
    ok = out == 1
    _log(f"[doctor] field self-test (r-1)^2 == 1 on {device}: {ok}")
    print("true" if ok else "false")
    return 0 if ok else 1


_LIB_HELP = "subcircuit library dir (optional when embedded or TZK_SUBCIRCUIT_LIBRARY is set)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tokamak_zk_evm_tpu_torch",
        description="Tokamak zk-SNARK pipeline on PyTorch / CUDA",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda; cpu runs the "
                        "plain PyTorch versions of the kernels)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser(
        "install",
        help="prepare a local runtime workspace (library + optional local "
             "trusted setup + provenance digests)")
    s.add_argument("--workspace", required=True)
    s.add_argument("--library", help=_LIB_HELP)
    s.add_argument("--no-setup", action="store_true",
                   help="skip CRS generation")
    s.add_argument("--fixed-tau", action="store_true")
    s.set_defaults(fn=cmd_install)

    s = sub.add_parser(
        "extract-proof",
        help="bundle instance/preprocess/proof JSON into one zip")
    s.add_argument("--synthesizer", required=True)
    s.add_argument("--preprocess", required=True)
    s.add_argument("--prove", required=True)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_extract_proof)

    s = sub.add_parser("setup", help="generate the CRS (trusted setup)")
    s.add_argument("--library", help=_LIB_HELP)
    s.add_argument("--output", required=True)
    s.add_argument("--fixed-tau", action="store_true",
                   help="deterministic trapdoor (testing only; matches the reference's --fixed-tau)")
    s.add_argument("--format", choices=("npz", "rkyv", "both"), default="both",
                   help="CRS artifact format: npz (native), rkyv "
                        "(reference combined_sigma.rkyv/sigma_preprocess.rkyv), or both")
    s.set_defaults(fn=cmd_setup)

    s = sub.add_parser("preprocess", help="commit permutation polynomials")
    s.add_argument("--crs", required=True)
    s.add_argument("--library", help=_LIB_HELP)
    s.add_argument("--synthesizer", required=True)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_preprocess)

    s = sub.add_parser("prove", help="generate a proof")
    s.add_argument("--crs", required=True)
    s.add_argument("--library", help=_LIB_HELP)
    s.add_argument("--synthesizer", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--deterministic", action="store_true",
                   help="zero blinding scalars (bit-exact proofs for testing)")
    s.add_argument("--testing-mode", action="store_true",
                   help="run in-round protocol identity asserts and emit "
                        "proof4_test.json (reference --features testing-mode)")
    s.set_defaults(fn=cmd_prove)

    s = sub.add_parser("verify", help="verify a proof")
    s.add_argument("--crs", required=True)
    s.add_argument("--library", help=_LIB_HELP)
    s.add_argument("--preprocess", required=True)
    s.add_argument("--proof", required=True)
    s.add_argument("--synthesizer", required=True)
    s.set_defaults(fn=cmd_verify)

    s = sub.add_parser("doctor", help="environment health check")
    s.set_defaults(fn=cmd_doctor)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
