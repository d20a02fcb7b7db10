#!/usr/bin/env python3
"""Where the bf16 time-channel backward (#1b') spends its time: the kernel
and throwaway copies of it without its trigonometry or without its
products, timed on the card, and its instructions per (entry, row) pair
counted in the SASS.

    python3 scripts/time_bwd_split.py --repo DIR [--variants full,no_trig,...]
                                      [--configs wikipedia,CanParl]

For each variant the script copies ``DIR``'s package into a temporary
directory, edits the copy's CUDA source by text substitution, and builds
and runs its ``time_channel`` library in a process of its own (the
variants' builds at once); the checkout itself is not touched. It knows
both designs of the kernel, the mma.sync one (``csrc/time_channel_bwd.cuh``
on the Bf16 product of ``csrc/time_products.cuh``, in older trees) and the
wgmma one (``csrc/time_channel_bf16_bwd.cuh``), and picks the
substitutions of the design ``DIR`` holds. The variants:
  * ``full``: the kernel as it is;
  * ``no_trig``: each argument theta taken as its own cosine and -sine (no
    reduction, no polynomials; everything else as it is);
  * ``no_products``: no matrix product (dPhi left at zero, dW not summed:
    the operands' fragments are not read either), the cosines folded into
    the dW accumulators so that they stay live;
  * ``small_only``: every warp on cosf's fast path (``sincos_small``), so
    that the SASS of the loop over stages holds one path of the
    trigonometry: its instruction count is what a pair costs there;
  * (the wgmma design) ``large_only``: every warp on the double
    reduction; ``producer_only``: the consumers skip every stage
    (the producers' loads, conversion and barriers alone);
    ``no_fetch``: the producer loads the first stage only and stores it
    into every stage (the consumers' work without the loads).
Each variant runs ``time_channel_backward(..., compute_dtype=bfloat16)``
at chip_smoke.py's DyGFormer shapes (600 rows of 32 positions at patch 1,
wikipedia; 600 of 2048 at patch 64, CanParl; Dt 100, ced 50; dt integers
below 1e6, 80% of positions valid, seed 2468): ms (CUDA events over
back-to-back calls) and device ms (the replay of a CUDA graph of those
calls), medians of 5. The SASS (``cuobjdump -sass`` of the built library)
gives, per variant, the kernel's instructions and those of its loop over
row stages (the shortest loop that holds all its tensor-core products;
code of paths not taken counts too), its opcodes counted, and that loop's
instructions per pair: divided by the pairs one thread handles in one
pass of it (16 in the mma.sync design's 32-row stages, 32 in the wgmma
design's 64-row ones). ``--sass-dir`` keeps each variant's SASS. Prints
the card's name and power limit, a line a variant, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from kernel_turns import card_line, cuda_ms, graph_ms  # noqa: E402

CONFIGS = {"wikipedia": (32, 1), "CanParl": (2048, 64)}

_WG_TRIG = "sincos_pairs<kFast>(x, cv, ms);"
# (marker of the design in csrc, kernel name's parts in the SASS, pairs a
# thread handles in one pass of the stage loop, variant -> [(file, old, new)])
DESIGNS = {
    "mma_sync": (
        ("time_products.cuh", "struct Bf16 {"),
        ("time_bwd_kernel", "Bf16"),
        16,
        {
            "no_trig": [("time_channel_bwd.cuh", "sincos_reduced<4>(x, cv, sv);",
                         "for (int q = 0; q < 4; ++q) cv[q] = x[q], sv[q] = x[q];")],
            "small_only": [("time_channel_bwd.cuh", "sincos_reduced<4>(x, cv, sv);",
                            "for (int q = 0; q < 4; ++q) sincos_small(x[q], cv[q], sv[q]);")],
            "no_products": [
                ("time_products.cuh",
                 "        bf16::mma(dphi[nt], wa, bf16::pack(b0.x, b0.y), bf16::pack(b1.x, b1.y));",
                 "        (void)b0, (void)b1;"),
                ("time_products.cuh", "    if (nt % 2 == 0) return;",
                 "    part[0][0] += (phi[nt][0] + phi[nt][1]) + (phi[nt][2] + phi[nt][3]);\n"
                 "    return;"),
            ],
        },
    ),
    "wgmma": (
        ("time_channel_bf16_bwd.cuh", "namespace time_bwd_bf16"),
        ("bf16_bwd_kernel",),
        32,
        {
            "no_trig": [("time_channel_bf16_bwd.cuh", _WG_TRIG,
                         "for (int q = 0; q < 8; ++q) cv[q] = x[q], ms[q] = x[q];")],
            "small_only": [("time_channel_bf16_bwd.cuh", _WG_TRIG,
                            "sincos_pairs<true>(x, cv, ms);")],
            "no_products": [
                ("time_channel_bf16_bwd.cuh", "dphi_product(dphi, w_desc, d_desc);",
                 "{ for (int q = 0; q < kAcc; ++q) dphi[q] = 0.f; }"),
                ("time_channel_bf16_bwd.cuh", "dw_product(part, a_frag, wg::desc_mn_sw128(stage));",
                 "{ for (int q = 0; q < 16; ++q)"
                 " part[q] = __uint_as_float(a_frag[q / 4][q % 4]); }"),
            ],
            "large_only": [("time_channel_bf16_bwd.cuh", _WG_TRIG,
                            "sincos_pairs<false>(x, cv, ms);")],
            "producer_only": [("time_channel_bf16_bwd.cuh", "const bool live = any != 0u;",
                               "const bool live = false && any != 0u;")],
            "no_fetch": [("time_channel_bf16_bwd.cuh", "      if (t + 1 < tiles) fetch(t + 1);\n",
                          "")],
        },
    ),
}


def design_of(csrc: Path) -> str:
    for name, ((fname, marker), *_rest) in DESIGNS.items():
        path = csrc / fname
        if path.exists() and marker in path.read_text():
            return name
    raise SystemExit(f"time_bwd_split: no known bf16 backward design in {csrc}")


def make_variant(repo: Path, tmp: Path, design: str, variant: str) -> Path:
    """A copy of repo's package with the variant's substitutions."""
    root = tmp / variant
    shutil.copytree(repo / "dyglib_tpu_torch", root / "dyglib_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for fname, old, new in DESIGNS[design][3].get(variant, []):
        path = root / "dyglib_tpu_torch" / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"time_bwd_split: {variant}: {old!r} found {text.count(old)} times "
                             f"in {fname}")
        path.write_text(text.replace(old, new))
    return root


def cuobjdump() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")


def sass_loop(lib: Path, parts: tuple, dump: Path | None = None) -> dict:
    """The kernel's (the SASS function whose name holds every one of
    ``parts``) instructions, and those between the head and the backward
    branch of its longest loop, with the loop's opcodes counted; NOPs left
    out. ``dump``: a directory to write each such function's SASS to."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    names = [n for n in funcs if all(p in n for p in parts)]
    if not names:
        raise SystemExit(f"time_bwd_split: no SASS function with {parts}")
    out = {}
    for fn in names:
        if dump is not None:
            dump.mkdir(parents=True, exist_ok=True)
            (dump / f"{fn[-60:]}.sass").write_text("\n".join(funcs[fn]))
        instrs, labels, branches = [], {}, []
        pending = []
        for line in funcs[fn]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
            if not m:
                continue
            addr, op, rest = int(m.group(1), 16), m.group(2), m.group(3)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            if op.startswith("NOP"):
                continue
            instrs.append((addr, op.split(".")[0]))
            if op.startswith("BRA"):
                t = re.search(r"\((\.L_x_\d+)\)", rest) or re.search(r"0x([0-9a-f]+)", rest)
                if t:
                    branches.append((addr, t.group(1)))
        spans = []
        for addr, target in branches:
            to = labels.get(target) if target.startswith(".L") else int(target, 16)
            if to is not None and to < addr:
                spans.append((addr - to, to, addr))
        # the loop over stages: the shortest that holds every tensor-core
        # product (the divergence stubs at the function's end branch back
        # over everything)
        products = [a for a, op in instrs if op in ("HGMMA", "HMMA")]
        holding = [sp for sp in spans if products and all(sp[1] <= a <= sp[2] for a in products)]
        loop, ops = 0, {}
        if spans:
            _, lo, hi = min(holding) if holding else max(spans)
            for a, op in instrs:
                if lo <= a <= hi:
                    loop += 1
                    ops[op] = ops.get(op, 0) + 1
        out[fn] = {"instructions": len(instrs), "loop_instructions": loop,
                   "loop_opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def prepare(root: Path, sass_dir: str) -> dict:
    """The variant's time_channel library built (in this process, which
    imports the variant's package): its SASS counts and ptxas's report;
    with ``sass_dir``, the kernel's SASS written there."""
    sys.path.insert(0, str(root))
    from dyglib_tpu_torch.ops import _build

    logs = _build.build(["time_channel"], ptxas_verbose=True)
    regs = [line.strip() for line in logs.get("time_channel", "").splitlines()
            if "registers" in line or "spill" in line]
    design = design_of(root / "dyglib_tpu_torch" / "csrc")
    _, parts, pairs, _ = DESIGNS[design]
    sass = sass_loop(_build.library_path("time_channel"), parts,
                     Path(sass_dir) if sass_dir else None)
    for v in sass.values():
        v["loop_instructions_per_pair"] = v["loop_instructions"] / pairs
    return {"sass": sass, "ptxas": regs}


def run_variant(root: Path, configs: list) -> dict:
    """The variant's backward timed at each config (in this process)."""
    import torch

    sys.path.insert(0, str(root))
    from dyglib_tpu_torch import ops
    from dyglib_tpu_torch.nn.modules import time_encoder_spectrum

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2468)
    dt_dim, ced, m = 100, 50, 600
    tw = torch.from_numpy(time_encoder_spectrum(dt_dim)).reshape(-1).to(dev)
    tb = 0.1 * torch.randn(dt_dim, device=dev, generator=gen)
    result = {}
    for config in configs:
        lp, patch = CONFIGS[config]
        dt = torch.randint(0, 1_000_000, (m, lp), device=dev, generator=gen).float()
        valid = torch.rand((m, lp), device=dev, generator=gen) < 0.8
        k = patch * dt_dim
        w = ((torch.rand((ced, k), device=dev, generator=gen) * 2 - 1) * k**-0.5).t()
        dout = 1e-3 * torch.randn((m, lp // patch, ced), device=dev, generator=gen)
        fn = lambda: ops.time_channel_backward(dt, valid, tw, tb, w, dout, patch,
                                               compute_dtype=torch.bfloat16)
        iters = 10 if lp > 100 else 100
        result[config] = {"ms": cuda_ms(fn, iters), "device_ms": graph_ms(fn, iters)}
    return result


def child(step: str, root: str, configs: str, sass_dir: str) -> int:
    out = (prepare(Path(root), sass_dir) if step == "build" else
           run_variant(Path(root), [c for c in configs.split(",") if c]))
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def spawn(step: str, root: Path, configs: str, sass_dir: str = "") -> subprocess.Popen:
    """This script in a process of its own for one variant: each variant's
    library is loaded alone (two libraries of one name in a process share
    their template statics, the kernels' shared-memory opt-in among them)."""
    return subprocess.Popen([sys.executable, __file__, "--child", step, "--root", str(root),
                             "--configs", configs, "--sass-dir", sass_dir],
                            stdout=subprocess.PIPE, text=True)


def result_of(proc: subprocess.Popen, what: str) -> dict:
    out, _ = proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"time_bwd_split: {what} failed (exit {proc.returncode})")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", help="checkout whose kernel to split")
    ap.add_argument("--variants", default="full,no_trig,no_products,small_only")
    ap.add_argument("--configs", default="wikipedia,CanParl")
    ap.add_argument("--sass-dir", default="", help="directory to write each variant's SASS to")
    ap.add_argument("--child", choices=("build", "time"), help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.root, args.configs, args.sass_dir)
    if not args.repo:
        ap.error("--repo is required")
    import torch

    if not torch.cuda.is_available():
        print("time_bwd_split: needs a CUDA card", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    design = design_of(repo / "dyglib_tpu_torch" / "csrc")
    print(card_line(), flush=True)
    out = {"repo": str(args.repo), "design": design, "device": torch.cuda.get_device_name(0)}
    variants = [v for v in args.variants.split(",") if v]
    with tempfile.TemporaryDirectory() as tmp:
        roots = {v: make_variant(repo, Path(tmp), design, v) for v in variants}
        builds = {v: spawn("build", roots[v], "",  # one nvcc each, at once
                           args.sass_dir and str(Path(args.sass_dir).resolve() / v))
                  for v in variants}
        built = {v: result_of(p, f"{v}'s build") for v, p in builds.items()}
        for v in variants:  # timed one at a time
            out[v] = {**built[v], **result_of(spawn("time", roots[v], args.configs), v)}
            times = {c: out[v][c] for c in args.configs.split(",") if c in out[v]}
            loops = {k[-12:]: (f["loop_instructions"], f["loop_instructions_per_pair"])
                     for k, f in out[v]["sass"].items()}
            print(f"{v} {json.dumps(times)} loop {json.dumps(loops)}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
