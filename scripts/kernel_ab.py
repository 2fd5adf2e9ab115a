#!/usr/bin/env python3
"""Compare the port's CUDA kernels with another checkout's on one card.

    python3 scripts/kernel_ab.py --other DIR [--reps 50]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists (`build/`). The script builds `pin_slam_tpu_torch/csrc/knn_join.cu`
and `csrc/fused_decode.cu` of both trees with nvcc, each into a directory
of its own under build/kernels/ab/ (so every run prints nvcc's register,
spill and shared-memory report of each instantiation of both trees), runs
both on the inputs of chip_smoke.py's kernel phases (the k-NN walk at the
tracker and training shapes, the fused decode at the mesher's batch and at
a ragged shape) and fails unless this tree's kernels give the other tree's
bits and agree with the plain versions (k-NN: idx, d2, cnt and visits
equal; fused decode: within chip_smoke.FUSED_ATOL). Then it times the two
in turns (other, this, this, other) with CUDA events and prints the results
as one JSON line.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NAMES = ("knn_join", "fused_decode")


def resources(log):
    """[(kernel template arguments, registers, spill bytes)] from a
    -Xptxas -v report."""
    out = []
    for fn, body in re.findall(
            r"Compiling entry function '(\w+)'.*?\n(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = sum(int(s) for s in re.findall(r"(\d+) bytes spill", body))
        targs = re.search(r"ILi(\d+)E(?:Li(\d+)E)?", fn)
        tag = "<" + ",".join(a for a in (targs.groups() if targs else ())
                             if a) + ">"
        out.append((tag, int(regs.group(1)) if regs else None, spill))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from pin_slam_tpu_torch.ops import cuda_build
    from pin_slam_tpu_torch.ops import fused_decode as fd
    from pin_slam_tpu_torch.ops import knn_join as kj

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"[device] {card}")

    # both trees' sources, one nvcc each, all started together
    roots = {"other": Path(args.other), "this": ROOT}
    procs = {}
    for tree, root in roots.items():
        out_dir = cuda_build.BUILD_DIR / "ab" / tree
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            src = root / "pin_slam_tpu_torch" / "csrc" / f"{name}.cu"
            out = out_dir / f"lib{name}.so"
            procs[tree, name] = (src, out, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {name: {} for name in NAMES}
    for (tree, name), (src, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        libs[name][tree] = ctypes.CDLL(str(out))
        smem = sorted(set(re.findall(r"(\d+) bytes smem", log)))
        cs.log(f"[build] {tree} {name}: " + ", ".join(
            f"{t} {r} regs {s} spill B" for t, r, s in resources(log))
            + f"; static shared memory {'/'.join(smem) or 0} B")

    def use(name, tree):
        cuda_build._LIBS[name] = libs[name][tree]

    with get_context("spawn").Pool(4) as pool:
        frames = pool.map(cs._frame, range(4))
    poses = cs.make_sequence(cs.N_FRAMES).poses

    def time_turns(name, fn):
        ms = {}
        for tree in ("other", "this", "this", "other"):
            use(name, tree)
            ms.setdefault(tree, []).append(cs.cuda_time_ms(fn, args.reps))
        use(name, "this")
        return ms

    result = {"card": card, "knn_join": {}, "fused_decode": {}}
    for shape, nq, kargs in cs.knn_cases(frames, poses, dev):
        outs = {}
        for tree in ("other", "this"):
            use("knn_join", tree)
            outs[tree] = kj._knn_walk_cuda(*kargs)
        ref = kj._knn_walk_plain(*kargs)
        torch.cuda.synchronize()
        for nm, a, b, c in zip(("idx", "d2", "cnt", "visits"), outs["this"],
                               outs["other"], ref):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"knn_join {shape}: {nm} differs")
        ms = time_turns("knn_join", lambda: kj._knn_walk_cuda(*kargs))
        v = outs["this"][3]
        result["knn_join"][shape] = dict(
            n=nq, k=kargs[5], visits=int(v.sum()), max_visits=int(v.max()),
            visit_histogram=cs.visit_histogram(v), ms=ms)
        cs.log(f"[knn_join] {shape}: N={nq} k={kargs[5]} visits "
               f"{int(v.sum())}, longest row {int(v.max())}, "
               f"{cs.visit_histogram(v)}; bits equal to the other tree's and "
               f"to the plain version; ms other {ms['other']} this "
               f"{ms['this']}")
    for shape, n, k, d, h, dargs in cs.decode_cases(dev):
        outs = {}
        for tree in ("other", "this"):
            use("fused_decode", tree)
            outs[tree] = fd.decode_weighted_sdf(*dargs)
        ref = fd.decode_weighted_sdf_reference(*dargs)
        torch.cuda.synchronize()
        same = torch.equal(outs["this"], outs["other"])
        err = float((outs["this"] - ref).abs().max())
        if err > cs.FUSED_ATOL:
            raise AssertionError(f"fused_decode {shape}: {err} from plain")
        ms = time_turns("fused_decode",
                        lambda: fd.decode_weighted_sdf(*dargs))
        result["fused_decode"][shape] = dict(
            n=n, k=k, d=d, h=h, bits_equal_other=same, max_abs_err=err,
            ms=ms)
        cs.log(f"[fused_decode] {shape}: N={n} k={k} bits equal to the "
               f"other tree's: {same}, max |err| vs plain {err}; ms other "
               f"{ms['other']} this {ms['this']}")
        if not same:
            raise AssertionError(f"fused_decode {shape}: bits differ from "
                                 "the other tree's kernel")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
