"""Device timings of the engine's per-iteration permutation, by op and by
``PERMUTE`` variant, plus the sort lowering XLA picks and the measured
device bytes per row.

All measurements run in ONE process (a JAX process reserves most of the
card, so a second one would fail for want of memory):

  hbm       bytes/row measured by ``hbm.measure_per_row_bytes`` at S = 20
            and S = 100, and the in-core row boundary that follows. Runs
            first: it differences the process-wide peak of device memory.
  hlo       the optimized HLO of ``engine._sort_state`` and
            ``engine.compact_sort`` under every PERMUTE variant, scanned for
            library radix-sort custom calls and XLA's own sort ops.
  ops       each primitive at [S, M = 2**logm]: one op runs REPS times
            inside one jitted ``lax.scan``, the best of 3 walls is divided
            by REPS. ``permute:<variant>`` is the engine's real
            ``_sort_state`` under that variant.
  sessions  one mode-C session (``engine.cluster_counts`` on
            ``bench.make_data`` at 2**logm × 20, I = 20, N = 0.8) under
            every PERMUTE variant: cold wall (compile included), then two
            warm walls taken in forward and reverse variant order, device
            and pull seconds, cluster count.

Usage:  python tools/iter_profile.py --all --logm 24 --out <file.json>
        python tools/iter_profile.py --hbm
Prints one JSON line per measurement; ``--out`` gets the whole record,
which names the device and the cards' power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S = 20
REPS = 4
VARIANTS = ("payload_sort_f16", "payload_sort", "gather_lane", "gather_rows")


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def measure_hbm() -> dict:
    from kmerlsh_tpu.utils import hbm

    out = {"limit_bytes": hbm.device_memory_bytes()}
    for s in (20, 100):
        per_row = hbm.measure_per_row_bytes(s)
        out[f"S{s}"] = {
            "measured_bytes_per_row": per_row,
            "static_bytes_per_row": hbm._per_row_bytes(s),
            "in_core_rows": (hbm.rows_budget(s, 1, per_row=per_row, fill=0.8)
                             if per_row else None),
            "static_in_core_rows": hbm.rows_budget(s, 1),
        }
    return _emit({"hbm": out})


def _sort_inputs(m: int):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, 1 << 20, size=m).astype(np.int32))
    sizes = jnp.asarray(rng.integers(0, 4, size=m).astype(np.int32))
    slots = jnp.arange(m, dtype=jnp.int32)
    mi = jnp.full((m,), -1, jnp.int32)
    vt = jnp.asarray(rng.standard_normal((S, m)).astype(np.float32))
    return key, sizes, slots, mi, vt


def sort_lowering(text: str) -> dict:
    """Count the sorts of one optimized HLO module by lowering: library
    radix-sort custom calls versus XLA's own (comparison) sort ops."""
    lines = text.splitlines()
    radix = [ln for ln in lines
             if "custom-call" in ln and "radixsort" in ln.lower()]
    xla = [ln for ln in lines if " sort(" in ln]
    return {"radix_custom_calls": len(radix), "xla_sorts": len(xla),
            "sort_lines": [ln.strip()[:240] for ln in radix + xla]}


def measure_hlo(logm: int, dump_dir: str | None) -> dict:
    import jax

    from kmerlsh_tpu.cluster import engine

    args = _sort_inputs(1 << logm)
    out = {}
    for v in VARIANTS:
        for name, fn, a in (
                ("sort_state", lambda k, s, c, mi, vt, v=v:
                 engine._sort_state(k, s, c, mi, vt, v), args),
                ("compact_sort", lambda k, s, c, mi, vt, v=v:
                 engine.compact_sort(vt, s, c, v), args)):
            text = jax.jit(fn).lower(*a).compile().as_text()
            out[f"{name}:{v}"] = sort_lowering(text)
            if dump_dir:
                os.makedirs(dump_dir, exist_ok=True)
                with open(os.path.join(dump_dir, f"{name}_{v}.hlo.txt"),
                          "w") as f:
                    f.write(text)
    return _emit({"hlo": out})


def _run_op(op: str, logm: int) -> dict:
    import jax
    import jax.numpy as jnp

    from kmerlsh_tpu.cluster import engine

    m = 1 << logm
    key, sizes, slots, mi, vt = _sort_inputs(m)
    iota = jnp.arange(m, dtype=jnp.int32)
    # a cheap full-period permutation avoids paying a sort to build one:
    # p(i) = (a*i + c) mod m with odd a (m is a power of two)
    perm = jnp.asarray(((2654435761 * np.arange(m, dtype=np.uint64) + 12345)
                        % m).astype(np.int32))

    def keys_for(r):
        k = jax.random.fold_in(jax.random.PRNGKey(7), r)
        return jax.random.randint(k, (m,), 0, 2**31 - 1, dtype=jnp.int32)

    if op.startswith("permute:"):
        variant = op.split(":", 1)[1]

        def body(carry, r):
            vt, sizes, slots = carry
            _, ssize, scs, _, svt = engine._sort_state(
                keys_for(r), sizes, slots, mi, vt, variant)
            return (svt, ssize, scs), ssize[0]
        carry = (vt, sizes, slots)
    elif op == "sort_kv":
        def body(carry, r):
            sk, si = jax.lax.sort((keys_for(r), iota), num_keys=1,
                                  is_stable=True)
            return carry + si[0], sk[0]
        carry = jnp.int32(0)
    elif op == "gather_lane":
        def body(carry, r):
            return carry[:, perm], carry[0, 0]
        carry = vt
    elif op == "gather_1d":
        def body(carry, r):
            return carry[perm], carry[0]
        carry = iota
    elif op == "segscan":
        def body(carry, r):
            vt, w = carry
            hd = jax.random.bernoulli(
                jax.random.fold_in(jax.random.PRNGKey(3), r), 0.3, (m,))
            W, WV, fill = engine._seg_scan(hd, w, vt, iota, m)
            return (WV, W), fill[0]
        carry = (vt, sizes)
    else:
        raise SystemExit(f"unknown op {op}")

    @jax.jit
    def prog(carry):
        return jax.lax.scan(body, carry, jnp.arange(REPS))

    t0 = time.perf_counter()
    jax.block_until_ready(prog(carry))          # compile + first run
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(prog(carry))
        walls.append(time.perf_counter() - t0)
    per_rep = min(walls) / REPS
    return _emit({"op": op, "logm": logm, "reps": REPS,
                  "first_call_s": compile_s, "walls_s": walls,
                  "per_rep_s": per_rep,
                  "ns_per_elem": per_rep / m * 1e9})


OPS = (["sort_kv", "gather_lane", "gather_1d", "segscan"]
       + [f"permute:{v}" for v in VARIANTS])


def measure_sessions(logm: int) -> dict:
    import jax

    import bench
    from kmerlsh_tpu.cluster import engine
    from kmerlsh_tpu.io import counts as countsio
    from kmerlsh_tpu.pipeline import mode_c_schedule

    n = 1 << logm
    with tempfile.TemporaryDirectory(prefix="kmerlsh_iterprof_") as root:
        sub = bench.make_data(n, root=root)
        kmap, covs = countsio.read_log(os.path.join(sub, "kmer_count.log"))
        counts = countsio.read_count_batch(
            os.path.join(sub, countsio.BIN_NAME), S, kmap, 0, kmap)
    v = np.asarray([c / kmap for c in covs], np.float32)
    schedule = mode_c_schedule(bench.ITERATIONS, bench.MIN_SIM)
    jcounts, n = engine.upload_counts(counts)
    del counts
    default = engine.PERMUTE

    def session(variant):
        engine.PERMUTE = variant
        t0 = time.perf_counter()
        _, sizes, groups = engine.cluster_counts(
            jcounts, v, schedule, seed=0, n=n, half_pull=True)
        wall = time.perf_counter() - t0
        return {"wall_s": wall,
                "device_s": engine.LAST_SESSION["device_seconds"],
                "pull_s": engine.LAST_SESSION["pull_seconds"],
                "clusters": len(groups),
                "programs": engine.LAST_SESSION.get("programs", [])}

    out = {}
    try:
        for var in VARIANTS:
            out[var] = {"cold": session(var)}
        for var in VARIANTS:
            out[var]["warm_fwd"] = session(var)
        for var in reversed(VARIANTS):
            out[var]["warm_rev"] = session(var)
    finally:
        engine.PERMUTE = default
    jax.block_until_ready(jcounts)
    return _emit({"sessions": out, "rows": n, "iterations": bench.ITERATIONS,
                  "default_permute": default})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", help="time one op (see OPS)")
    ap.add_argument("--logm", type=int, default=24)
    ap.add_argument("--all", action="store_true",
                    help="hbm, hlo, every op and every session variant")
    ap.add_argument("--hbm", action="store_true",
                    help="only the measured device bytes/row")
    ap.add_argument("--out", help="write the whole record here as JSON")
    args = ap.parse_args()

    from kmerlsh_tpu.utils.jaxcache import enable_compilation_cache
    from kmerlsh_tpu.utils.timing import device_record

    enable_compilation_cache()
    record = {"device": device_record()}
    _emit(record)
    if args.op:
        record["ops"] = [_run_op(args.op, args.logm)]
    if args.all or args.hbm:
        record["hbm"] = measure_hbm()["hbm"]
    if args.all:
        dump = (os.path.join(os.path.dirname(args.out), "hlo")
                if args.out else None)
        record["hlo"] = measure_hlo(args.logm, dump)["hlo"]
        record["ops"] = [_run_op(op, args.logm) for op in OPS]
        record["sessions"] = measure_sessions(args.logm)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
