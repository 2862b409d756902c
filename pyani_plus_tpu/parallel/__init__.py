"""Run orchestration: the replacement for Snakemake + SLURM.

The reference splits the N x N comparison matrix into N column jobs
dispatched as subprocesses or SLURM jobs coordinated through a shared
filesystem and a polled SQLite DB (SURVEY.md section 2.4). Here the
orchestration is in-process: genomes are ingested once, the pending-pair
set is derived from the content-addressed store (giving cache/resume for
free), and the method kernels compute whole tiles of pairs at a time on
the accelerator. Multi-host sharding over a ``jax.sharding.Mesh`` lives
in ``pyani_plus_tpu.parallel.tiles``.
"""

from pyani_plus_tpu.parallel.runner import start_and_run_method

__all__ = ["start_and_run_method"]
