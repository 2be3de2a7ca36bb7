"""Typed run configuration (port of ``sagecal_tpu/config.py``).

The same enums and the same field names as the JAX package's
``RunConfig``, so a configuration translates field for field. Fields
that pick a JAX execution plan (fuse/promote learners, prefetch depth)
are kept for flag parity; the port documents which of them are no-ops.
"""

from __future__ import annotations

import dataclasses
import enum


class SolverMode(enum.IntEnum):
    """Solver selection, parity with ``-j`` (reference Dirac.h SM_*)."""

    OSLM_LBFGS = 0
    LM_LBFGS = 1
    RLM_RLBFGS = 2
    OSLM_OSRLM_RLBFGS = 3
    RTR_OSLM_LBFGS = 4
    RTR_OSRLM_RLBFGS = 5
    NSD_RLBFGS = 6


class BeamMode(enum.IntEnum):
    """Parity with ``-B``."""

    NONE = 0
    ARRAY = 1
    FULL = 2
    ELEMENT = 3


class SimulationMode(enum.IntEnum):
    """Parity with ``-a``."""

    OFF = 0
    SIMULATE = 1
    ADD = 2
    SUBTRACT = 3


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Full-batch and stochastic calibration run configuration (CLI flag
    in comments)."""

    ms: str | None = None              # -d
    ms_list: str | None = None         # -f
    sky_model: str | None = None       # -s
    cluster_file: str | None = None    # -c
    solutions_file: str | None = None  # -p : output (input under -a)
    init_solutions: str | None = None  # -q : warm start
    format_3: bool = False             # -F 1
    input_column: str = "DATA"         # -I
    output_column: str = "CORRECTED_DATA"   # -O

    tile_size: int = 120               # -t
    max_em_iter: int = 3               # -e
    max_iter: int = 10                 # -g
    max_lbfgs: int = 10                # -l
    lbfgs_m: int = 7                   # -m
    solver_mode: SolverMode = SolverMode.RTR_OSRLM_RLBFGS  # -j
    robust_nulow: float = 2.0          # -L
    robust_nuhigh: float = 30.0        # -H
    randomize: bool = True             # -R
    # 0 Cholesky 1 QR 2 SVD in the reference; selects nothing here, as in
    # the JAX package (solvers/lm.py: one jittered Cholesky retry)
    linsolv: int = 1                   # --linsolv

    uvmin: float = 0.0                 # -x (lambda)
    uvmax: float = 1e9                 # -y
    # short-baseline taper of the solve input in meters (0 = off;
    # data.cpp:546-550); a RunConfig field only, no CLI flag, as in the
    # JAX package
    uvtaper: float = 0.0
    mmse_rho: float = 1e-9             # -o
    whiten: bool = False               # -W : uv-density whitening
    per_channel_bfgs: bool = False     # -b 1 : per-channel LBFGS solves

    simulation: SimulationMode = SimulationMode.OFF  # -a
    ignore_clusters_file: str | None = None          # -z
    correct_cluster: int | None = None               # -k
    phase_only: bool = False                         # -J
    beam_mode: BeamMode = BeamMode.NONE              # -B
    n_epochs: int = 0                                # -N
    n_minibatches: int = 1                           # -M
    # stochastic minibatch loss: "robust" (Student's t) or "huber"
    stochastic_loss: str = "robust"                  # --loss
    channel_avg_per_band: int = 1                    # -w : mini-bands
    n_admm: int = 1                                  # -A
    # stochastic consensus (-N with -A > 1 and -w > 1): the polynomial
    # over the bands, its rho, and the consensus value as the solution
    n_poly: int = 2                                  # -P
    poly_type: int = 2                               # -Q
    admm_rho: float = 5.0                            # -r
    rho_file: str | None = None                      # -G
    use_global_solution: bool = False                # RunConfig only
    max_timeslots: int = 0                           # -T
    # the MPI CLI's -N route (federated.py): the first solve interval and
    # the federated prior's strength
    skip_timeslots: int = 0                          # -K
    federated_alpha: float = 0.0                     # -u
    verbose: bool = False                            # -V : per-tile stats

    # --tile-batch: solve intervals batched into one lane-batched solve
    # (sage.sagefit_host_tiles); T > 1 makes the warm start per batch:
    # every tile of a batch starts from the solution carried into it
    tile_batch: int = 1                # --tile-batch
    # execution plan: in the JAX package these pick jit fusion and
    # whole-solve promotion; PyTorch runs eagerly, so both are no-ops
    solve_fuse: str = "auto"           # --solve-fuse
    solve_promote: str = "auto"        # --solve-promote
    # clusters solved concurrently per SAGE sweep step (block-Jacobi
    # groups, sage.SageConfig.inflight); 1 = the reference's sequencing
    cluster_inflight: int = 1          # --inflight
    solver_inner: str = "chol"         # --inner
    # --kernel: "pallas" the fused sweep where it fits (else the XLA
    # assembly, as the JAX package falls back); "xla" the XLA assembly.
    # The JAX CLI defaults to "xla"; the port keeps its kernels' route
    solver_kernel: str = "pallas"
    jones_mode: str = "full"           # --jones
    dtype_policy: str = "f32"          # --dtype-policy
    # --resume: continue from the tile-boundary checkpoint beside the
    # solutions file (io/solutions.py: checkpoint_path)
    resume: bool = False
    # --shard-baselines: one subband's rows over the process's devices
    # (parallel.py); tile batches off, as in the JAX package
    shard_baselines: bool = False

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
