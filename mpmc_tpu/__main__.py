"""CLI entry point: ``python -m mpmc_tpu <input-file>``.

Mirrors the reference's single-argument invocation (SURVEY.md §2
"Entry/CLI", src/main/main.c [C]): one plain-text input script selects the
ensemble and all options (§2.9 grammar).
"""
from __future__ import annotations

import argparse
import sys

import jax


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mpmc_tpu",
        description="Molecular Monte Carlo on an accelerator (MPMC "
        "rebuild)")
    ap.add_argument("input", help="input script (MPMC option-value grammar)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (parity/float64 runs)")
    ap.add_argument("--jsonl", default=None,
                    help="write per-corrtime observables as JSONL")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host run: bootstrap jax.distributed so "
                    "all hosts' devices form one replica mesh (the "
                    "reference's multi-node MPI job)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (--distributed)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mpmc_tpu.utils import compile_cache
    compile_cache.enable()
    if args.distributed:
        from mpmc_tpu.parallel import multihost
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)

    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod

    job = input_script.parse_file(args.input)
    if job.cfg.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    print(f"mpmc_tpu: job '{job.cfg.job_name}' ensemble={job.cfg.ensemble} "
          f"backend={jax.default_backend()} "
          f"devices={len(jax.devices())}")
    if job.unknown_options:
        print(f"WARNING: unknown options: {job.unknown_options}",
              file=sys.stderr)
    run_mod.run(job, **({"jsonl_path": args.jsonl}
                        if job.cfg.ensemble in ("nvt", "uvt", "npt", "nve")
                        else {}))


if __name__ == "__main__":
    main()
