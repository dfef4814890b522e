#!/usr/bin/env python3
"""What a family of the port's kernels costs on one GPU: registers, SASS,
time.

    python3 kernel_report.py [--lib poseidon|ntt] [--pipes] [--out DIR]
                             TREE [TREE ...]

Each TREE is a directory holding a copy of this repository (for example a
`git archive` of a commit, unpacked). For each TREE in the order given, in a
process of its own, it:
  1. builds that tree's city_rollup_tpu_torch/csrc/<lib>.cu (its own
     _build.py: nvcc -Xptxas -v) and keeps each kernel's registers and
     spills (read by this checkout's _build.ptxas_usage);
  2. disassembles the library (cuobjdump -sass) and counts, per kernel, the
     SASS instructions, the loops (backward branches) and their bodies by
     opcode. For permute_kernel (one permutation a thread) it estimates the
     instructions of one permutation as the code outside the loops plus each
     loop body times its trips (4 full rounds, 22 partial, 4 full); for the
     NTT block kernels, the instructions a value costs in a middle
     radix-16 pass (middle_pass_sass);
  3. checks the family's kernels against their plain versions at a small
     shape, then times its entries with CUDA events on inputs made from one
     seed, while nvidia-smi samples the SM clock:
     - poseidon (default): K3 permute_t at (12, 2^17), K4 sponge_t at
       (64, 2^23), K4 reduce_level_t at (4, 2^23) (the one-shot commit's
       first tree level) and K5 absorb_t at (12, 2^23) + (8, 2^23);
     - ntt: the public ntt.coset_lde at the commits' shapes, one streamed
       slab (8, 2^22) -> (8, 2^25) and the one-shot input (64, 2^20) ->
       (64, 2^23), beside the byte bound of a two-pass LDE (the
       coefficients read once, one intermediate written and read once,
       the LDE written once);
  4. hashes each output (sha256 of its bytes).
Trees of the same function must give the same hashes; the script fails if
two trees disagree, or if a kernel disagrees with its plain version. For
the Poseidon core, the achieved instruction rate is the estimate of step 2
times the permutations a second, against the dispatch peak of 132 SMs x 4
schedulers x 32 lanes x the sampled SM clock. The SASS and the compiler
logs go to DIR (default profile_out/), with every number in
kernel_report_<lib>.json; the last line is one JSON object of the main
numbers of all trees. Run in turns (old new new old) to compare two
versions on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

P = 0xFFFF_FFFF_0000_0001
SMS, SCHEDULERS, LANES = 132, 4, 32
TRIPS = (4, 22, 4)          # permute_kernel's three round loops, in order
MEM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
RATE_BITS = 3


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def parse_sass(text: str) -> dict:
    """{kernel: [(address, opcode, text)]} from cuobjdump -sass output."""
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            body = m.group(2)
            words = body.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                cur.append((int(m.group(1), 16), words[0], body))
    return funcs


def _op_class(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD":
        return "IMAD.WIDE" if ".WIDE" in op else (
            "IMAD.HI" if ".HI" in op else "IMAD")
    if base in ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS",
                "PRMT", "MOV", "ULDC", "LDC", "LDG", "STG", "BRA"):
        return base
    return "other"


def _counts(instrs) -> dict:
    out: dict = {}
    for _, op, _ in instrs:
        if op == "NOP":
            continue
        c = _op_class(op)
        out[c] = out.get(c, 0) + 1
    out["total"] = sum(out.values())
    return out


def sass_summary(instrs) -> dict:
    """Instruction counts of a kernel, its loops and, for a kernel with the
    three round loops of one permutation, the estimate per permutation."""
    real = [x for x in instrs if x[1] != "NOP"]
    loops = []
    for addr, op, body in real:
        if op.startswith("BRA"):
            m = re.findall(r"0x([0-9a-f]+)", body)
            if m and int(m[-1], 16) < addr:
                start = int(m[-1], 16)
                loops.append((start, addr))
    loops.sort()
    summary = {"static": _counts(real), "loops": []}
    for start, end in loops:
        body = [x for x in real if start <= x[0] <= end]
        summary["loops"].append({"start": hex(start), "end": hex(end),
                                 "counts": _counts(body)})
    top = [lp for lp in loops
           if not any(o != lp and o[0] <= lp[0] and lp[1] <= o[1]
                      for o in loops)]
    if len(top) == len(TRIPS):
        per_perm = summary["static"]["total"]
        for (start, end), trips in zip(top, TRIPS):
            n = sum(1 for x in real if start <= x[0] <= end)
            per_perm += (trips - 1) * n
        summary["per_permutation"] = per_perm
    return summary


class ClockSampler:
    """nvidia-smi's SM clock and power, every 100 ms, while it is open; it
    opens once the first sample has come."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100", "--id=0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.first = threading.Event()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.first.wait(timeout=20)
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))
            self.first.set()

    def __exit__(self, *exc):
        time.sleep(0.25)
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.reader.join(timeout=30)
        return False

    def busy_clock_mhz(self) -> float | None:
        """Median SM clock over the samples taken under load (power above
        the midpoint of the range seen)."""
        if not self.samples:
            return None
        lo = min(w for _, w in self.samples)
        hi = max(w for _, w in self.samples)
        busy = [m for m, w in self.samples if w >= (lo + hi) / 2]
        return statistics.median(busy or [m for m, _ in self.samples])


# --- pipe probe ---------------------------------------------------------------
# Kernels of independent chains of one or two instruction kinds; the rate of
# each is its loop body's SASS instructions times the trips, per clock per
# scheduler (1.0 = one warp instruction every cycle).
PROBE_KINDS = {
    # each kind feeds its result back into an operand, so that ptxas can
    # neither hoist nor fold it
    "iadd": "add.u32 %0, %0, %1; add.u32 %1, %1, %0;",
    "imad": "mad.lo.u32 %0, %0, %1, %1;",
    "imad.wide": "mad.wide.u32 %2, %0, %1, %2; cvt.u32.u64 %0, %2;",
    "dfma": "fma.rn.f64 %3, %3, %4, %4;",
}
PROBE_MIXES = [("iadd",), ("imad",), ("imad.wide",), ("dfma",),
               ("iadd", "imad.wide"), ("iadd", "imad"), ("iadd", "dfma"),
               ("imad.wide", "dfma")]


def _probe_source() -> str:
    out = ["#include <cstdint>", "#include <cuda_runtime.h>"]
    for n, mix in enumerate(PROBE_MIXES):
        body = []
        for u in range(8):
            kind = mix[u % len(mix)]
            body.append(f'asm volatile("{PROBE_KINDS[kind]}" : "+r"(a[{u}]), '
                        f'"+r"(b[{u}]), "+l"(w[{u}]), "+d"(d[{u}]) : '
                        f'"d"(e[{u}]));')
        out.append(f"""
__global__ void probe{n}(uint64_t* out, int iters) {{
  uint32_t a[8], b[8]; uint64_t w[8]; double d[8], e[8];
  for (int u = 0; u < 8; ++u) {{
    a[u] = threadIdx.x + u; b[u] = 3 + u; w[u] = u; d[u] = u; e[u] = 1.0;
  }}
  for (int i = 0; i < iters; ++i) {{
#pragma unroll
    for (int j = 0; j < 16; ++j) {{
      {chr(10).join(body)}
    }}
  }}
  uint64_t s = 0;
  for (int u = 0; u < 8; ++u) s += a[u] + b[u] + w[u] + (uint64_t)d[u];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}""")
    cases = "\n".join(f"    case {n}: probe{n}<<<blocks, threads, 0, st>>>"
                      f"(out, iters); break;"
                      for n in range(len(PROBE_MIXES)))
    out.append(f"""
extern "C" int city_probe(int which, int blocks, int threads, int iters,
                          uint64_t* out, void* stream) {{
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {{
{cases}
    default: return -1;
  }}
  return (int)cudaGetLastError();
}}""")
    return "\n".join(out)


def pipe_probe(out_dir: Path) -> list:
    import ctypes
    import torch
    src = out_dir / "pipe_probe.cu"
    lib_path = out_dir / "libpipe_probe.so"
    src.write_text(_probe_source())
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(lib_path), str(src)], check=True, timeout=300)
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    (out_dir / "sass_pipe_probe.txt").write_text(sass)
    funcs = parse_sass(sass)
    lib = ctypes.CDLL(str(lib_path))
    lib.city_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    dev = torch.device("cuda", 0)
    blocks, threads, iters = 132 * 8, 256, 4000
    out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for n, mix in enumerate(PROBE_MIXES):
        name = next(k for k in funcs if f"probe{n}" in k)
        body = sass_summary(funcs[name])["loops"]
        inner = max(body, key=lambda lp: lp["counts"]["total"])["counts"]

        def run():
            rc = lib.city_probe(n, blocks, threads, iters, out.data_ptr(),
                                stream)
            if rc:
                raise RuntimeError(f"probe {mix}: CUDA error {rc}")
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        reps = max(5, int(1.0 / (time.perf_counter() - t0)))
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with ClockSampler() as clk:
            start.record()
            for _ in range(reps):
                run()
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        mhz = clk.busy_clock_mhz()
        warps = blocks * threads // 32
        per_clock = (inner["total"] * iters * warps
                     / (ms * 1e-3 * mhz * 1e6 * SMS * SCHEDULERS))
        results.append({"mix": "+".join(mix), "body": inner, "ms": ms,
                        "sm_clock_mhz": mhz,
                        "warp_instructions_per_clock_per_scheduler":
                            per_clock})
        print(f"probe {'+'.join(mix)}: {per_clock:.3f} warp instructions "
              f"per clock per scheduler ({inner})", flush=True)
    return results


def middle_pass_sass(instrs) -> float | None:
    """SASS instructions a value costs in a middle radix-16 pass of an NTT
    block kernel, from its static code: the loop whose body stores 16
    values to shared memory is one thread's radix-16 group (every pass's
    code, each taken or not); its path from the loop's start to the last of
    those stores (the group's set-up, 16 loads, the DFT in registers, the
    twiddles between passes, the stores) over 16 values. An estimate: the
    loads of a first pass that sit inside that stretch are counted too."""
    real = [x for x in instrs if x[1] != "NOP"]
    best = None
    for addr, op, body in real:
        if not op.startswith("BRA"):
            continue
        m = re.findall(r"0x([0-9a-f]+)", body)
        if not m or int(m[-1], 16) >= addr:
            continue
        loop = [x for x in real if int(m[-1], 16) <= x[0] <= addr]
        sts = [i for i, x in enumerate(loop) if x[1].startswith("STS")]
        if len(sts) == 16:
            best = (sts[-1] + 1) / 16
    return best


def _poseidon_runs(rand, with_edges, res):
    """Checks of K3, K4 and K5 against their plain versions, then the
    timed runs: (name, shape, permutations, make inputs, fn, reps)."""
    import torch
    from city_rollup_tpu_torch.core import cuda_poseidon as cp
    label = res["label"]
    checks = [
        ("permute", lambda x: cp.permute_t(x), cp.permute_t_plain,
         (12, 1 << 12)),
        ("sponge n=64", cp.sponge_t, cp.sponge_t_plain, (64, 1 << 12)),
        ("sponge n=8", cp.sponge_t, cp.sponge_t_plain, (8, 1 << 12)),
        ("level", cp.reduce_level_t,
         lambda x: cp.sponge_t_plain(torch.cat([x[:, 0::2], x[:, 1::2]])),
         (4, 1 << 13))]
    for name, kern, plain, shape in checks:
        x = with_edges(rand(shape))
        if not torch.equal(kern(x), plain(x)):
            raise AssertionError(f"{label}: {name} disagrees with its plain "
                                 "version")
    s, c = with_edges(rand((12, 1 << 12))), with_edges(rand((8, 1 << 12)))
    if not torch.equal(cp.absorb_t(s, c), cp.absorb_t_plain(s, c)):
        raise AssertionError(f"{label}: absorb disagrees with its plain "
                             "version")
    return [
        ("poseidon_permute", "(12, 2^17)", 1 << 17,
         lambda: [rand((12, 1 << 17))], cp.permute_t, 500),
        ("poseidon_sponge", "(64, 2^23)", 8 << 23,
         lambda: [rand((64, 1 << 23))], cp.sponge_t, 5),
        ("poseidon_sponge level", "(4, 2^23)", 1 << 22,
         lambda: [rand((4, 1 << 23))], cp.reduce_level_t, 100),
        ("poseidon_absorb", "(12, 2^23) + (8, 2^23)", 1 << 23,
         lambda: [rand((12, 1 << 23)), rand((8, 1 << 23))], cp.absorb_t,
         40)]


def _ntt_runs(rand, with_edges, res):
    """A coset LDE and an ntt against the plain radix-2 transform (of the
    padded, scaled coefficients), then the timed coset LDEs."""
    import torch
    from city_rollup_tpu_torch.core import ntt
    label = res["label"]
    c = with_edges(rand((3, 1 << 11)))
    root = ntt._root_table(11 + RATE_BITS, False, c.device)
    want = ntt._ntt_core(ntt._coset_scale_pad(c, 11, RATE_BITS, 7), root,
                         11 + RATE_BITS)
    if not torch.equal(ntt.coset_lde(c, 11, RATE_BITS), want):
        raise AssertionError(f"{label}: coset_lde disagrees with the plain "
                             "radix-2 transform")
    x = with_edges(rand((3, 1 << 14)))
    if not torch.equal(ntt.ntt(x, 14), ntt._ntt_core(x, root, 14)):
        raise AssertionError(f"{label}: ntt disagrees with the plain "
                             "radix-2 transform")
    return [
        (f"coset_lde {what}", f"({b}, 2^{n})", None,
         lambda b=b, n=n: [rand((b, 1 << n)), n, RATE_BITS],
         ntt.coset_lde, 5)
        for what, b, n in [("streamed slab", 8, 22), ("one-shot", 64, 20)]]


def _lde_bound_ms(shape: str) -> float:
    """Byte bound of a coset LDE of (b, 2^n) coefficients at RATE_BITS."""
    b, n = re.fullmatch(r"\((\d+), 2\^(\d+)\)", shape).groups()
    b, n = int(b), 1 << int(n)
    return 8 * b * (n + 3 * (n << RATE_BITS)) / MEM_BYTES_PER_S * 1e3


FAMILIES = {"poseidon": _poseidon_runs, "ntt": _ntt_runs}


def one_tree(tree: Path, label: str, lib_name: str, out_dir: Path) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(tree))
    from city_rollup_tpu_torch import _build, convert

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res: dict = {"label": label, "tree": str(tree), "lib": lib_name}
    lib = _build.library_path(lib_name)
    if lib.exists():
        lib.unlink()
    t0 = time.perf_counter()
    log = _build.build((lib_name,))[lib_name]
    res["build_s"] = time.perf_counter() - t0
    (out_dir / f"ptxas_{lib_name}_{label}.txt").write_text(log)
    res["ptxas_log"] = log
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    (out_dir / f"sass_{lib_name}_{label}.txt").write_text(sass)
    res["sass"] = {}
    for k, v in parse_sass(sass).items():
        res["sass"][k] = sass_summary(v)
        if lib_name == "ntt":
            res["sass"][k]["middle_pass_per_value"] = middle_pass_sass(v)

    rng = np.random.default_rng(0)

    def rand(shape):
        return convert.from_u64(
            rng.integers(0, P, size=shape, dtype=np.uint64), dev)

    edge = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63]

    def with_edges(x):
        for j, v in enumerate(edge):
            x[:, j] = v - (1 << 64) if v >= 1 << 63 else v
        return x

    def ms_of(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with ClockSampler() as clk:
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, clk.busy_clock_mhz()

    runs = FAMILIES[lib_name](rand, with_edges, res)
    per_perm = next((v.get("per_permutation") for k, v in res["sass"].items()
                     if "permute_kernel" in k), None)
    res["times"] = {}
    for name, shape, perms, make, fn, reps in runs:
        args = make()
        out = fn(*args)
        digest = hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        torch.cuda.empty_cache()
        ms, mhz = ms_of(lambda: fn(*args), reps)
        entry = {"shape": shape, "ms": ms, "sm_clock_mhz": mhz,
                 "digest": digest}
        if perms is None:
            entry["bound_ms"] = _lde_bound_ms(shape)
        else:
            entry["permutations_per_s"] = perms / ms * 1e3
        if perms and per_perm and mhz:
            rate = per_perm * perms / ms * 1e3
            peak = SMS * SCHEDULERS * LANES * mhz * 1e6
            entry["instructions_per_s"] = rate
            entry["share_of_dispatch_peak"] = rate / peak
        res["times"][name] = entry
        del args
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--lib", choices=sorted(FAMILIES), default="poseidon")
    ap.add_argument("--pipes", action="store_true",
                    help="also run the pipe probe first")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.one:
        import torch
        if not torch.cuda.is_available():
            print("kernel_report: CUDA is not available", file=sys.stderr)
            return 1
        print(json.dumps(one_tree(Path(args.one).resolve(), args.label,
                                  args.lib, out_dir)), flush=True)
        return 0
    if not args.trees and not args.pipes:
        ap.error("give at least one TREE, or --pipes")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from city_rollup_tpu_torch import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    probe = pipe_probe(out_dir) if args.pipes else None
    results = []
    for i, tree in enumerate(args.trees):
        label = f"{i}-{Path(tree).name}"
        proc = subprocess.run(
            [sys.executable, __file__, "--one", tree, "--label", label,
             "--lib", args.lib, "--out", str(out_dir)], capture_output=True,
            text=True,
            timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{tree}: failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["ptxas"] = _build.ptxas_usage(res.pop("ptxas_log"))
        res["sass"] = {_build.kernel_name(k): v
                       for k, v in res["sass"].items()}
        results.append(res)
        perm = res["sass"].get("permute_kernel", {})
        print(f"{label}: build {res['build_s']:.1f} s; per-permutation SASS "
              f"{perm.get('per_permutation')}, static "
              f"{perm.get('static', {}).get('total')}", flush=True)
        for k, v in res["ptxas"].items():
            sm = res["sass"].get(k, {})
            print(f"  {k}: {v}, SASS {sm.get('static', {}).get('total')}"
                  + (f", a value in a middle radix-16 pass "
                     f"~{sm['middle_pass_per_value']}"
                     if sm.get("middle_pass_per_value") else ""),
                  flush=True)
        for k, v in res["times"].items():
            share = v.get("share_of_dispatch_peak")
            print(f"  {k} {v['shape']}: {v['ms']:.4f} ms at "
                  f"{v['sm_clock_mhz']} MHz"
                  + (f", {share:.3f} of dispatch peak" if share else "")
                  + (f", byte bound {v['bound_ms']:.4f} ms"
                     if "bound_ms" in v else ""), flush=True)
    for name in (results[0]["times"] if results else ()):
        digests = {r["times"][name]["digest"] for r in results}
        if len(digests) != 1:
            raise SystemExit(f"{name}: trees disagree on the output")
    print(card, flush=True)
    (out_dir / f"kernel_report_{args.lib}.json").write_text(
        json.dumps({"card": card, "pipes": probe, "trees": results},
                   indent=1))
    print(json.dumps({"card": card, "trees": [{
        "label": r["label"],
        "per_permutation": r["sass"].get("permute_kernel", {}).get(
            "per_permutation"),
        "registers": {k: v.get("registers") for k, v in r["ptxas"].items()},
        "ms": {k: v["ms"] for k, v in r["times"].items()}}
        for r in results]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
