"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sagecal_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version on the card at the shapes the full-batch path gives it (phases
``coh``, ``sweep``, ``matvec``, ``visits``), checks the port's pipeline on
the card against the same pipeline on the CPU at ``-j 1``, at the default
solver mode (on 16 stations, where it runs as OS-LM, and on 41, robust
RTR), at ``-j 5 --inner cg``, and with in-flight cluster groups
(``--inflight 2`` on 8 clusters at ``-j 1`` and ``-j 5 --inner cg``;
``slice_parity``), and drives the full-batch CLI end to end on a
synthetic observation at full width (62 LOFAR-like stations, 120
timeslots, 8 channels, clusters of 64 sources; every e2e phase at ``-e
1``): ``e2e`` at ``-j 1`` on one tile and ``e2e_rtr`` at ``-j 5 --inner
cg`` (robust RTR with
the matvec kernel in every tCG product) on two, with 8 clusters;
``e2e_inflight`` at ``-j 5 --inner cg --inflight 4 -e 1`` on two tiles
with 16 clusters (the multi-visit sweep kernel in every group solve).
Batches of solve intervals (``--tile-batch``): ``visits`` also holds the
kernel at V = 8 lanes (4 tiles of 2 visits), every operand and the chunk
ids per visit; ``matvec`` holds and times the matvec kernel on such
records at V = 4 and 8 visits of 4 chunks (16 and 32 chunks, the tCG
products of a batch); ``slice_parity`` adds ``tile_batch_rtr`` (``-j 5 --inner
cg --tile-batch 2``, 3 tiles) and ``tile_batch_inflight`` (``-j 1
--tile-batch 2 --inflight 2``, 8 clusters, 3 tiles); and
``e2e_tile_batch`` runs ``-j 5 --inner cg --tile-batch 4 -e 1`` at full
width on 5 tiles (tile 0 alone, tiles 1-4 one batch, which must launch the
visits and matvec kernels and no single-visit sweep), its batch's EM,
refine and per-tile seconds printed beside e2e_rtr's warm tile 1.
Skies of every morphology: ``predict_mixed`` holds the split predict
(the coherency kernel on the point/gaussian half, the eager envelopes on
the shapelet/disk/ring rest) at full width against the generic predict in
float64 on the card; ``slice_parity`` adds ``xla_default`` (``-j 5
--kernel xla``, the JAX CLI's default command line, on a mixed sky),
``xla_cg`` (its ``--inner cg``) and ``kmax5`` (``-j 1`` on 16 stations, a 5-chunk cluster, no
``--kernel`` flag: the XLA fallback); and ``e2e_mixed`` runs ``-j 5
--kernel xla -e 1`` at full width on the mixed sky (one tile). The XLA-route
runs must launch no sweep, matvec or visits kernel and count XLA solves;
every other run must count none.
Constrained Jones modes (``--jones diag|phase``): the sweep, visits and
matvec phases run each kernel at md = 2 and md = 1 too; ``slice_parity``
adds ``diag_j1``, ``phase_cg`` and ``diag_inflight_rtr``; and ``e2e_diag``
(``-j 1 --jones diag``) and ``e2e_phase`` (``-j 5 --inner cg --jones
phase -e 1``) run one tile each on e2e_rtr's observation. A run in a mode must
launch its solve kernels at that mode's md only, and its solutions'
off-diagonals must be exactly 0.
Stochastic calibration (``-N``): ``coh`` also holds and times the kernel
at the band shapes of ``e2e_stochastic`` (a minibatch of 30 timeslots,
4 evenly spaced channels; a padded 3-channel band, uneven: the sincos
path), ``slice_parity`` adds ``stochastic`` (``-N 2 -M 2 -w 2`` on 16
stations, 8 channels, 2 tiles of 20 timeslots: per-tile residuals and
solutions within 1e-3, every Armijo decision equal or the first flip within
FLIP_MARGIN of its threshold), and ``e2e_stochastic`` runs ``-N 2 -M 4
-w 2`` at full width on e2e_rtr's first 2 tiles. A stochastic run must
launch the coherency kernel and no solve kernel.
The solve, correction and simulation options: ``manifold`` holds the
phase extraction of ``-J 1`` (``consensus/manifold.extract_phases``, its
3x3 eigenproblems on the card) against the CPU on identity and random J;
``slice_parity`` adds ``bandpass`` (``-b 1``), ``whiten_phase`` (``-W 1
-J 1 -k``), ``warm`` (``-q``), ``sim`` (``-a 2 -p -z``, a pure predict:
its written column within SIM_RTOL of the data's largest magnitude) and
``stochastic_warm`` (``-N`` with ``-q``), the first three with their
written columns within PARITY_RTOL of it too; and on e2e_rtr's observation ``e2e_bandpass`` (``-j 1 -b 1 -e 1``:
every channel's LBFGS fit lowers its cost, and the coherency kernel
launches once at F = 1 for the joint solve and once at F = 8 for all
channels' solves and residuals), ``e2e_whiten_phase`` (``-j 5 --inner
cg -W 1 -J 1 -k 0 -e 1``) and ``e2e_sim`` (``-a 1/2/3 -p`` e2e_rtr's
solutions ``-z`` one cluster, on the first tile: the three modes compose
and the ignored cluster is absent).
Reduced storage (``--dtype-policy bf16|f16``): ``sweep`` and ``visits``
hold and time the bf16 and f16 instances of the sweep kernel at full width
in each Jones mode (K = 4; the rows 80 bytes a row where float32's are
128), checked at K = 1 and on the empty chunk too; ``slice_parity`` adds
``bf16_default`` (the default mode on single-chunk clusters: the reduced
OS fast path), ``f16_j1_xla`` (the reduced XLA assembly and LU),
``f16_j1`` (the f16 sweep instance) and ``bf16_inflight_rtr`` (the bf16
visits instance), each on an observation of its own (REDUCED_OBS) against
the port's CPU run at the same policy at max(PARITY_RTOL, SPREAD_FACTOR x
the larger of the CPU run's own spread under a one-float32-ulp move of
every source flux and the card's run-to-run spread over SPREAD_REPS card
runs), a gate of at most SPREAD_CAP, every card run held to it with
every relaxation decision equal, and within ENVELOPE of the CPU run
without the policy;
``e2e_bf16`` (``-j 5 --inner cg``, e2e_rtr's first tile) and
``e2e_f16_inflight`` (``-j 5 --inner cg --inflight 4``, e2e_inflight's
first tile) run at full width, launch only their policy's sweep
instances, and land within ENVELOPE of the float32 run's final residual.
Input, restart and the station beam: ``native`` builds the
tile packer (``csrc/tile_pack.cc``, host code, g++) and holds it against
its numpy version at full width (226,920 rows, 8 channels, 10% channel
flags, a taper) within 1e-12, with both times; ``slice_parity`` adds, on
16 stations, ``beam_array`` (``-j 1 -B 1``), ``beam_full`` (the default
mode, ``-B 2``), ``beam_element_tile_batch`` (``-j 5 --inner cg -B 3
--tile-batch 2``, 3 tiles) and ``beam_stochastic`` (``-N 2 -M 2 -w 2 -B
2``, the stochastic gates), each on an observation simulated through the
full beam of a stored ``beam.npz``, each launching no coherency kernel,
and ``beam_full_t10`` (``beam_full`` at 10 timeslots a tile, where
float32 itself lies ~3e-3 from float64) against the port's float32 CPU
run, gated as the reduced runs;
``multims`` (``-f`` of 2 subbands, one with channel flags: the native
packer; each part's written column too) and ``resume`` (killed at tile 1
and resumed: the resumed tiles' residuals and the whole solutions file
against the CPU's uninterrupted run; the card run must go through the
native packer); and ``e2e_beam`` runs ``-j 5 --inner cg -B 2 -e 1`` on
a one-tile full-width observation of e2e_rtr's sky and gains simulated
through the full beam of its stored ``beam.npz``: sweep and matvec
launched, coh not, with the tile wall and the beam predict's seconds and
peak device memory.
Consensus calibration: ``e2e_consensus`` runs the MPI CLI
(``cli_mpi``) on 4 full-width subbands (one tile each, the 8 channels at
centres 130-170 MHz, gains smooth in frequency) at ``-A 3 -P 2 -j 1
--inner cg -e 1`` (coh, sweep and matvec launched, no XLA solve, every
subband's residual falling; the wall of each ADMM iteration and the
interval, the dual residuals, peak memory) and
``e2e_stochastic_consensus`` e2e_stochastic's run at ``-A 3`` on one tile;
``slice_parity`` adds ``consensus`` (``-j 1 --inner cg -C 1 -G``, 3
subbands of 16 stations), ``consensus_rtr_inflight`` (``-j 4 --inner cg
--inflight 2``, 8 clusters: the visits kernel under ADMM) and
``stochastic_consensus`` (``-N 1 -M 2 -w 2 -A 2 -r 0.5``:
STOCHASTIC_CONSENSUS, ROADMAP C14): per subband its
residuals and written column, and the Z file after each block's gauge
unitary (LM only: CONSENSUS_PARITY), within PARITY_RTOL of the CPU's
float64 run, every divergence reset and flagged band equal.
The MPI CLI's other plans: ``e2e_federated`` runs ``-N 1 -M 2 -w 2 -A 2
-u 0.5`` (federated stochastic calibration) on 2 full-width subbands, one
tile (the coherency kernel and no solve kernel; every slave's residual
falling; the tile wall and its split, FEDA per outer iteration, peak
memory); ``slice_parity`` adds ``federated`` (``-N`` on 2 slaves of 16
stations at ``-r 0.5``: the stochastic gates, every slave's column),
``consensus_blocked`` (``--block-f 2``), ``consensus_stale``
(``--staleness 2`` with an ``admm_subband_slow`` fault plan: the
schedules and dead sets equal) and ``consensus_time_shard``
(``--time-shard 2`` over 3 tiles), each ``-j 1 --inner cg`` on the
consensus parity subbands (coh, sweep and matvec launched, no XLA solve).
slice_parity's card runs and its CPU float64 references share one
queue of PARITY_WORKERS spawned processes; the e2e phases run after it,
with the card and the host to themselves.
Every phase prints one JSON line; any failure ends the run with a
non-zero exit. The last lines are the card's name and power limit
(``nvidia-smi``), a ``{"kernels": [...]}`` summary and ``{"ok": true,
"device": {...}}``.

Importing this module does nothing; it imports neither ``jax`` nor
``sagecal_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

#: published H100 SXM peaks: HBM bandwidth and float32 (non-tensor) rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: tolerances: kernel vs plain on the card (float32, another summation
#: order), and the card (float32) pipeline vs the CPU (float64) one
KERNEL_RTOL = 1e-4
PARITY_RTOL = 1e-3
#: the simulation run of slice_parity (a pure predict): its written
#: column, card against CPU
SIM_RTOL = 1e-4
#: a group's relaxation decision may differ between the card and the CPU
#: only where the trial that decided it was within this relative margin
#: of its threshold on both sides (float32 against float64 roundoff)
FLIP_MARGIN = 1e-3
#: --dtype-policy: the reduced storage policies, and the envelope of a
#: reduced run's final residual against the float32 run's, |res_1 /
#: res_1(f32) - 1| (tests/test_dtype_policy.py's ENVELOPE)
REDUCED = ("bf16", "f16")
ENVELOPE = {"bf16": 0.25, "f16": 0.10}
#: a reduced run's card-against-CPU gate is max(PARITY_RTOL, SPREAD_FACTOR
#: x the CPU run's own spread): how far the CPU run moves when every
#: source flux moves by one float32 ulp (:func:`perturb_sky`). Float32
#: roundoff flips roundings to the storage dtype, which the solves carry
#: on, so the card's float32 sums in another order move a reduced run as
#: far as that does
SPREAD_FACTOR = 10
#: ... and that gate may not exceed SPREAD_CAP (a tenth of the f16
#: envelope): a run whose CPU result moves further under one ulp is
#: roundoff-chaotic (ROADMAP queue C, C10), and its comparison would check
#: nothing, so the phase fails
SPREAD_CAP = 1e-2
#: ... and the card moves a run by itself: the order of its atomic sums
#: (index_add_) changes from run to run (ROADMAP C7, C10). A spread-gated
#: run (a reduced policy, or SPREAD_F32_RUNS) runs SPREAD_REPS times on the
#: card; its card spread is the largest range of a per-tile res_0/res_1
#: over those runs (relative to the CPU's), and its gate max(PARITY_RTOL,
#: SPREAD_FACTOR x the larger spread), clamped at SPREAD_CAP (the CPU
#: spread alone past SPREAD_CAP still fails the run). Every card run is
#: held to it
SPREAD_REPS = 3

N_STATIONS = 62
TILESZ = 120
FREQS = 150e6 + 0.18e6 * (np.arange(8) - 3.5)
N_CLUSTERS = 8
N_SOURCES = 64
NCHUNK = (1, 1, 2, 1, 4, 1, 2, 1)
#: e2e_inflight: 16 clusters, so that groups of 4 survive the M//4 clamp
NCHUNK16 = NCHUNK * 2
#: visits: the in-flight group width of e2e_inflight
N_VISITS = 4
#: visits: the lanes of a batch of solve intervals with groups (T = 4
#: tiles of G = 2 visits: --tile-batch 4 --inflight 2)
N_LANES = 8
#: e2e_tile_batch: tiles a batch (the first tile solves alone)
TILE_BATCH = 4
RA0 = 2.0 * math.pi / 12
DEC0 = 52.0 * math.pi / 180
#: a beam observation's first time (MJD seconds), its tiles following
#: each other at 10 s a timeslot
BEAM_START_MJD_S = 4.93e9


#: the run's start, for each record's elapsed seconds
T_START = time.perf_counter()


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 200) -> float:
    """CUDA-event time of ``reps`` back-to-back calls of ``fn()`` divided
    by the count (close to device time once the host keeps ahead)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_us(fn, names: tuple, reps: int = 20, traces: int = 4):
    """Mean device time (us) of the CUDA kernels whose name contains one
    of ``names`` per call of ``fn()`` (``("",)``: every kernel), from a
    ``torch.profiler`` trace of ``reps`` calls (CUPTI); None when none of
    up to ``traces`` traces holds such a kernel (a trace on the card now
    and then drops every record of a kernel, so another is taken, as
    :func:`kernels_per_call` does). A trace can also lose some kernel
    records (3 of 20 once), so each kernel counts its mean over the
    records kept times its launches a call: records over ``reps``,
    rounded, for a kernel in at least every other call, else unrounded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            if any(n in ev.key for n in names) and t > 0 and ev.count:
                per_call = ev.count / reps
                total += t / ev.count * (round(per_call) if per_call >= 0.5
                                         else per_call)
        if total > 0:
            return total
    return None


def kernels_per_call(fn, name: str, launches, reps: int = 5):
    """(CUDA kernels launched per call of ``fn()``, traces taken), counted
    in a ``torch.profiler`` trace of ``reps`` calls between two spin
    kernels (``torch.cuda._sleep``) that are not counted. A trace is
    accepted when its kernels a call are a whole number and its count of
    the kernel ``name`` equals the wrapper's own launch counter
    (``launches()``) over the same calls: a trace on the card now and
    then loses a kernel record (1 of 8 traces in a probe; two in a row
    once), so up to 4 traces are taken, and none that agrees fails the
    phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for traces in range(1, 5):
        n0 = launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
        counted = (launches() - n0) / reps
        kernels = [ev for ev in prof.key_averages()
                   if "spin_kernel" not in ev.key
                   and getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0)) > 0]
        total = sum(ev.count for ev in kernels) / reps
        named = sum(ev.count for ev in kernels if name in ev.key) / reps
        if total == int(total) and named == counted:
            return total, traces
        seen.append(dict(kernels=total, named=named, counter=counted))
    raise AssertionError(f"{name}: no trace of 4 agreed with the launch "
                         f"counter: {seen}")


def _template_args(mangled: str) -> list:
    """The template arguments at the head of a mangled name's rest
    (``ILb0ELi4E13__nv_bfloat16E...``): bools, ints, ``float`` and named
    types; [] when it holds none."""
    import re
    if not mangled.startswith("I"):
        return []
    out, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L([ib])(\d+)E", mangled[i:])
        if m:
            k, v = m.groups()
            out.append(v if k == "i" else ("true" if v == "1" else "false"))
            i += m.end()
        elif mangled[i] == "f":
            out.append("float")
            i += 1
        else:
            m = re.match(r"(\d+)", mangled[i:])
            if not m:
                return []
            n = int(m.group(1))
            j = i + m.end()
            out.append(mangled[j:j + n])
            i = j + n
    return out


def ptxas_resources(source: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} of one source's
    kernels, read from the compiler's ``-Xptxas -v`` report."""
    import re
    from sagecal_tpu_torch.ops import cuda_lib
    res, name = {}, None
    for ln in cuda_lib.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            name = m.group(2)[:int(m.group(1))]
            # a kernel template's int, bool and type arguments
            # (ILi8ELb1EE, ILb0ELi4E13__nv_bfloat16E)
            args = _template_args(m.group(2)[int(m.group(1)):])
            if args:
                name += "<" + ", ".join(args) + ">"
            res[name] = {"registers": None, "spill_stores": 0,
                         "spill_loads": 0}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            res[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            res[name]["registers"] = int(m.group(1))
    return res


def bound_ms(n_bytes: float, n_ops: float):
    tb = n_bytes / PEAK_BYTES_S * 1e3
    to = n_ops / PEAK_F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def rel_err(got, ref) -> tuple:
    d = float((got - ref).abs().max())
    return d, d / max(float(ref.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# synthetic observation
# ---------------------------------------------------------------------------

def _hms(rad: float):
    h = (rad * 12 / math.pi) % 24
    hh = int(h)
    mm = int((h - hh) * 60)
    ss = ((h - hh) * 60 - mm) * 60
    return f"{hh} {mm} {ss:.6f}"


def _dms(rad: float):
    d = rad * 180 / math.pi
    sign = "-" if d < 0 else ""
    d = abs(d)
    dd = int(d)
    mm = int((d - dd) * 60)
    ss = ((d - dd) * 60 - mm) * 60
    return f"{sign}{dd} {mm} {ss:.6f}"


def mixed_kinds(n_sources: int) -> str:
    """The morphologies of a mixed cluster, one letter a source (the LSM
    name's lead: P point, G gaussian, D disk, R ring, S shapelet): at 64
    sources 4 shapelets, 2 disks, 2 rings, 16 gaussians and 40 points;
    fewer sources take the pattern SDRGP over and over."""
    if n_sources >= 24:
        return "SSSSDDRR" + "G" * 16 + "P" * (n_sources - 24)
    return ("SDRGP" * n_sources)[:n_sources]


def _write_modes(path: str, n0: int, rng) -> None:
    """A shapelet's ``.fits.modes`` file: n0^2 modes, decaying with the
    order, and a scale beta of 0.5-2 mrad."""
    n1, n2 = np.meshgrid(np.arange(n0), np.arange(n0))
    modes = rng.normal(0, 1.0, (n0, n0)) * 0.5 / (1.0 + n1 + n2)
    with open(path, "w") as f:
        f.write("0 0 0 0 0 0\n"
                f"{n0} {float(rng.uniform(5e-4, 2e-3)):.8e}\n")
        f.writelines(f"{i} {x:.10e}\n" for i, x in enumerate(modes.ravel()))


def write_sky(path: str, n_clusters: int, n_sources: int, nchunk, seed: int,
              mixed: bool = False):
    """An LSM sky file + cluster file: ``n_clusters`` patches of
    ``n_sources`` sources within ~3 degrees of the phase centre, a
    quarter of them gaussians; with ``mixed`` the morphologies of
    :func:`mixed_kinds` (shapelets of n0 = 2..6, their ``.fits.modes``
    files beside the sky file; disks and rings of 0.1-1 mrad)."""
    rng = np.random.default_rng(seed)
    lines, clus = [], []
    for m in range(n_clusters):
        c_ra = RA0 + rng.normal(0, 0.03) / math.cos(DEC0)
        c_dec = DEC0 + rng.normal(0, 0.03)
        kinds = mixed_kinds(n_sources) if mixed else "".join(
            "G" if s % 4 == 0 else "P" for s in range(n_sources))
        names = []
        n_sh = 0
        for s, kind in enumerate(kinds):
            name = f"{kind}{m}_{s}"
            ra = c_ra + rng.normal(0, 0.004) / math.cos(DEC0)
            dec = c_dec + rng.normal(0, 0.004)
            sI = float(rng.uniform(0.2, 2.0))
            eX = eY = eP = 0.0
            if kind == "G":
                eX, eY, eP = (float(rng.uniform(1e-4, 4e-4)),
                              float(rng.uniform(5e-5, 2e-4)),
                              float(rng.uniform(0, math.pi)))
            elif kind in "DR":
                eX = float(rng.uniform(1e-4, 1e-3))
            elif kind == "S":
                eX, eY = (float(x) for x in rng.uniform(0.7, 1.3, 2))
                eP = float(rng.uniform(0, math.pi))
                _write_modes(os.path.join(os.path.dirname(path),
                                          name + ".fits.modes"),
                             2 + (m + n_sh) % 5, rng)
                n_sh += 1
            lines.append(f"{name} {_hms(ra)} {_dms(dec)} {sI:.6f} 0 0 0 "
                         f"-0.7 0 {eX:.6e} {eY:.6e} {eP:.6f} 150e6")
            names.append(name)
        clus.append(f"{m} {nchunk[m]} " + " ".join(names))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path + ".cluster", "w") as f:
        f.write("\n".join(clus) + "\n")
    return path, path + ".cluster"


def make_observation(work: str, n_stations: int, tilesz: int, freqs,
                     n_clusters: int, n_sources: int, nchunk, n_tiles: int,
                     device, seed: int = 5, noise: float = 0.01,
                     mixed: bool = False, beam: int = 0,
                     chan_flags: float = 0.0, name: str = "obs.ms"):
    """Sky files (``mixed``: :func:`write_sky`'s mixed morphologies) + a
    SimMS ``name`` of ``n_tiles`` tiles corrupted by random Jones,
    simulated on ``device``, a ``chan_flags`` share of its channels
    flagged. With ``beam`` (a ``-B`` mode) the tiles follow each other in
    time and are simulated through that station beam of a
    ``synthetic_beam`` over their times, stored as the SimMS's
    ``beam.npz``. Returns (ms, sky, cluster) paths."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.rime import predict as rp
    os.makedirs(work, exist_ok=True)
    sky_path, clus_path = write_sky(os.path.join(work, "sky.txt"),
                                    n_clusters, n_sources, nchunk, seed,
                                    mixed=mixed)
    sky = skymodel.read_sky_cluster(sky_path, clus_path, RA0, DEC0,
                                    float(np.mean(freqs)))
    rdt = torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
    dsky = rp.split_sky(sky, rdt, device)
    J = ds.random_jones(sky.n_clusters, sky.nchunk, n_stations, seed=seed,
                        scale=0.2)
    info, kw = None, [{} for _ in range(n_tiles)]
    if beam:
        from sagecal_tpu_torch.rime import beam as bm
        starts = [BEAM_START_MJD_S + i * tilesz * 10.0
                  for i in range(n_tiles)]
        jd = [(s + 10.0 * (np.arange(tilesz) + 0.5)) / 86400.0 + 2400000.5
              for s in starts]
        f0 = float(np.mean(freqs))
        info = bm.synthetic_beam(n_stations, np.concatenate(jd), RA0, DEC0,
                                 f0, band=bm.band_for_freq(f0), seed=seed)
        kw = [dict(beam=bm.beam_to_device(info, f0, rdt, time_jd=jd[i],
                                          device=device),
                   dobeam=beam, start_mjd_s=starts[i]) for i in range(n_tiles)]
    tiles = [ds.simulate_dataset(dsky, n_stations, tilesz, freqs, RA0, DEC0,
                                 jones=J, nchunk=sky.nchunk,
                                 noise_sigma=noise, seed=seed + 10 * i,
                                 chan_flag_fraction=chan_flags, **kw[i])
             for i in range(n_tiles)]
    ms = os.path.join(work, name)
    ds.SimMS.create(ms, tiles, beam_info=info)
    return ms, sky_path, clus_path


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi[0] if smi else ""


def phase_build():
    from sagecal_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    ptxas = {n: [ln.strip() for ln in cuda_lib.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in cuda_lib.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, built=built,
         ptxas=ptxas)


#: native: the full-width tile the packer is held at (rows, channels),
#: its share of flagged channels and its taper (m)
NATIVE_SHAPE = (TILESZ * N_STATIONS * (N_STATIONS - 1) // 2, len(FREQS))
NATIVE_FLAGS = 0.1
NATIVE_TAPER_M = 300.0


def phase_native() -> dict:
    """The tile packer (``io/native.py``: ``csrc/tile_pack.cc`` built
    with g++, host code) against its numpy version at full width, with a
    tenth of the channels flagged and a taper: x8 within 1e-12 of its
    largest magnitude, the row flags and the flag ratio equal. Emits both
    times (median of 3 calls), the build seconds and the library."""
    from sagecal_tpu_torch.io import native
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(14)
    nrow, nchan = NATIVE_SHAPE
    vis = (rng.normal(size=(nrow, nchan, 2, 2))
           + 1j * rng.normal(size=(nrow, nchan, 2, 2)))
    cf = (rng.random((nrow, nchan)) < NATIVE_FLAGS).astype(np.uint8)
    u, v = rng.normal(0, 2000.0, nrow), rng.normal(0, 2000.0, nrow)
    args = (vis, cf, u, v, nrow)
    kw = dict(uvtaper_m=NATIVE_TAPER_M, freq0=float(np.mean(FREQS)))

    def timed(fn):
        out, secs = None, []
        for _ in range(3):
            t = time.perf_counter()
            out = fn(*args, **kw)
            secs.append(time.perf_counter() - t)
        return out, float(np.median(secs))

    got, native_s = timed(native.pack_tile)
    ref, numpy_s = timed(native.pack_tile_py)
    err = float(np.abs(got[0] - ref[0]).max() / np.abs(ref[0]).max())
    rec = dict(rows=nrow, channels=nchan, flagged=NATIVE_FLAGS,
               taper_m=NATIVE_TAPER_M, native_s=native_s, numpy_s=numpy_s,
               build_s=build_s, lib=native.LIB_PATH, max_rel_err=err,
               flags_equal=bool(np.array_equal(got[1], ref[1])),
               fratio=[got[2], ref[2]],
               row_flags={int(k): int(n) for k, n in zip(
                   *np.unique(got[1], return_counts=True))})
    emit("native", **rec)
    if not (err <= 1e-12 and rec["flags_equal"] and got[2] == ref[2]):
        raise AssertionError(f"native: the packer disagrees with its numpy "
                             f"version: {rec}")
    return rec


def _coh_inputs(F: int, per_channel: bool, seed: int = 1, fl=None,
                n_times: int = TILESZ):
    """The coherency kernel's inputs at the full-width path's shapes, the
    number of gaussians, and the host's channel list (from which the
    pipeline decides the channel step). ``fl`` (a host channel list)
    and ``n_times`` (timeslots of rows) give a stochastic band's shape:
    a minibatch's rows and one band's channels, at the channel width."""
    import torch
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.ops import coh as coh_ops
    from sagecal_tpu_torch.rime import predict as rp
    from sagecal_tpu_torch import skymodel
    dev = "cuda"
    path = os.path.join(WORK, "coh_sky.txt")
    os.makedirs(WORK, exist_ok=True)
    sky_path, clus_path = write_sky(path, N_CLUSTERS, N_SOURCES, NCHUNK, seed)
    sky = skymodel.read_sky_cluster(sky_path, clus_path, RA0, DEC0, 150e6)
    # exercise the tangent-frame projection on every gaussian
    sky.use_projection[sky.stype == skymodel.STYPE_GAUSSIAN] = True
    dsky = rp.sky_to_device(sky, torch.float32, dev)
    xyz = ds.random_array(N_STATIONS, seed=seed)
    ha = np.linspace(0.0, ds.OMEGA_E * 10.0 * TILESZ, TILESZ,
                     endpoint=False)[:n_times]
    u, v, w, _, _ = ds.uvw_tracks(xyz, DEC0, ha)
    t = lambda a: torch.as_tensor((a / ds.C_M_S).reshape(-1),
                                  dtype=torch.float32, device=dev)
    band = fl is not None
    if not band:
        fl = FREQS[:F] if F > 1 else np.array([150e6])
    freqs = torch.as_tensor(fl, dtype=torch.float32, device=dev)
    uvw3 = torch.stack([t(u), t(v), t(w)])
    geom = torch.stack([dsky.ll, dsky.mm, dsky.nn], dim=1)
    flux = coh_ops.stokes_weights(dsky, freqs, per_channel)
    gauss = coh_ops.gauss_coeffs(dsky)
    fdelta = 0.18e6 * (8 if F == 1 and not band else 1)
    n_gauss = int((sky.stype == skymodel.STYPE_GAUSSIAN).sum())
    return (uvw3, geom, flux, gauss, freqs, fdelta), n_gauss, fl


#: edge shapes of the coh phase: (tag, channels F, sources S, source
#: kinds, channel spacing), at M = 3 clusters and B = 1000 rows (not a
#: multiple of the kernel's 256-row block). F = 17 takes three channel
#: tiles (6, 6, 5), S = 130 crosses the 128-source shared-memory chunk.
COH_EDGES = (("F1", 1, 64, "mixed", "even"), ("F3", 3, 64, "mixed", "even"),
             ("F8", 8, 64, "mixed", "even"),
             ("F17", 17, 64, "mixed", "even"),
             ("S1", 8, 1, "mixed", "even"), ("S130", 8, 130, "mixed", "even"),
             ("points", 8, 64, "point", "even"),
             ("gaussians", 8, 64, "gauss", "even"),
             ("uneven", 8, 64, "mixed", "uneven"),
             ("F17_S130_uneven", 17, 130, "mixed", "uneven"))


def _coh_edge_inputs(F: int, S: int, kind: str, spacing: str,
                     seed: int = 11, M: int = 3, B: int = 1000):
    """Coherency kernel inputs at an edge shape, at the full-width path's
    phase magnitudes: B rows of the 62-station tracks (the longest
    baseline among them), clusters of S sources ~0.004 around centres
    ~0.03 from the phase centre, Stokes weights with a -0.7 spectral
    index, gaussian projection and shape coefficients on the sources
    ``kind`` marks (every source, none, or every fourth). Returns (args,
    number of gaussians, the host's channel list)."""
    import torch
    from sagecal_tpu_torch.io import dataset as ds
    rng = np.random.default_rng(seed)
    xyz = ds.random_array(N_STATIONS, seed=1)
    ha = np.linspace(0.0, ds.OMEGA_E * 10.0 * TILESZ, TILESZ, endpoint=False)
    u, v, w, _, _ = ds.uvw_tracks(xyz, DEC0, ha)
    u, v, w = (a.reshape(-1) / ds.C_M_S for a in (u, v, w))
    rows = rng.choice(u.size, B, replace=False)
    rows[0] = np.argmax(u * u + v * v)
    uvw3 = np.stack([u[rows], v[rows], w[rows]])
    lm = rng.normal(0, 0.03, (M, 2, 1)) + rng.normal(0, 0.004, (M, 2, S))
    n = np.sqrt(1 - (lm ** 2).sum(1)) - 1
    geom = np.concatenate([lm, n[:, None]], axis=1)
    if spacing == "even":
        fl = 150e6 + 0.18e6 * (np.arange(F) - (F - 1) / 2)
    else:
        fl = 149e6 + np.cumsum(np.round(rng.uniform(0.1e6, 0.3e6, F), -3))
    sI = rng.uniform(0.2, 2.0, (M, 1, S)) * (fl[:, None] / 150e6) ** -0.7
    sQ, sU, sV = (rng.uniform(-0.1, 0.1, (M, 1, S)) for _ in range(3))
    flux = np.stack(np.broadcast_arrays(sI + sQ, sI - sQ, sU, sV), axis=2)
    xi, phi, eP = (rng.uniform(0, np.pi, (M, S)) for _ in range(3))
    eX = 2 * rng.uniform(1e-4, 4e-4, (M, S))
    eY = 2 * rng.uniform(5e-5, 2e-4, (M, S))
    isg = {"point": np.zeros((M, S)), "gauss": np.ones((M, S)),
           "mixed": (np.arange(S) % 4 == 0) * np.ones((M, S))}[kind]
    gauss = np.stack([np.cos(xi), -np.cos(phi) * np.sin(xi),
                      np.sin(phi) * np.sin(xi), np.sin(xi),
                      np.cos(phi) * np.cos(xi), -np.sin(phi) * np.cos(xi),
                      eX * np.cos(eP), -eX * np.sin(eP), eY * np.sin(eP),
                      eY * np.cos(eP), isg], axis=1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    args = (f32(uvw3), f32(geom), f32(flux), f32(gauss), f32(fl),
            0.18e6 * (8 if F == 1 else 1))
    return args, int(isg.sum()), fl


def _coh_random_inputs(F: int, S: int, seed: int = 0, M: int = 3,
                       B: int = 1000):
    """Coherency kernel inputs of random geometry: uvw of ~1e-5 s (up to
    ~12 km; phases up to ~4e3 rad), sources ~0.03 from the phase centre,
    random fluxes and gaussian coefficients, about half the sources
    gaussians, channels 1 MHz apart from 150 MHz. Returns (args, number
    of gaussians, the host's channel list)."""
    import torch
    rng = np.random.default_rng(seed)
    uvw3 = rng.normal(0, 1e-5, (3, B))
    geom = np.stack([rng.normal(0, 0.03, (M, S)),
                     rng.normal(0, 0.03, (M, S)),
                     -rng.random((M, S)) * 1e-3], axis=1)
    flux = rng.random((M, F, 4, S))
    gauss = rng.normal(0, 1e-3, (M, 11, S))
    gauss[:, 10] = rng.random((M, S)) > 0.5
    fl = 150e6 + 1e6 * np.arange(F)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    args = (f32(uvw3), f32(geom), f32(flux), f32(gauss), f32(fl), 0.18e6)
    return args, int(gauss[:, 10].sum()), fl


#: random-geometry cases of the coh phase: (tag, F, S, held to the plain
#: version). With one source an output carries its float32 phase
#: roundoff undiluted, and at ~4e3 rad kernel against plain measures the
#: plain version's own roundoff: that case is held to float64 alone.
COH_RANDOM = (("random_uvw", 4, 20, True), ("random_uvw_S1", 8, 1, False))


def _coh_check(tag, args, step, vs_plain: bool = True):
    """The coherency kernel against its plain version on ``args``, twice
    (one launch a call, bitwise equal), and both against the plain
    version in float64 on the card as the truth: the kernel's error
    there may be at most 2x the float32 plain version's (a change of
    formulation moves float32 roundoff in a phase of 1e3 rad).
    ``vs_plain`` False leaves out only the kernel-against-plain gate
    (COH_RANDOM). Returns (max |diff|, relative error, the kernel's and
    the float32 plain's error against float64)."""
    import torch
    from sagecal_tpu_torch.ops import coh as coh_ops
    n0 = coh_ops.LAUNCHES
    got = coh_ops.coherencies_points(*args, step=step)
    again = coh_ops.coherencies_points(*args, step=step)
    torch.cuda.synchronize()
    if coh_ops.LAUNCHES != n0 + 2:
        raise AssertionError(f"coh {tag}: the wrapper did not launch once "
                             "a call")
    if not torch.equal(got, again):
        raise AssertionError(f"coh {tag}: two calls differ")
    ref = coh_ops.coherencies_points_plain(*args)
    abs_err, rel = rel_err(got, ref)
    if vs_plain and not rel <= KERNEL_RTOL:
        raise AssertionError(f"coh kernel {tag}: max|diff|/max|ref| = "
                             f"{rel:.3e} > {KERNEL_RTOL}")
    truth = coh_ops.coherencies_points_plain(
        *(a.double() for a in args[:5]), args[5])
    err_kernel = rel_err(got.double(), truth)[1]
    err_plain = rel_err(ref.double(), truth)[1]
    del truth
    if not err_kernel <= 2 * err_plain:
        raise AssertionError(f"coh kernel {tag}: error against float64 "
                             f"{err_kernel:.3e} > 2x the float32 plain "
                             f"version's {err_plain:.3e}")
    return abs_err, rel, err_kernel, err_plain


def phase_coh():
    """The coherency kernel against its plain version (and both against
    float64) at the full-width path's shapes, the solve (F = 1) and the
    residual (F = 8, evenly spaced channels: the phasor recurrence; also
    timed and checked with the per-channel sincos the kernel takes for
    uneven channels), then at the edge shapes and on random geometry
    (COH_RANDOM); one kernel a call by a ``torch.profiler`` count that
    agrees with the wrapper's launch counter."""
    from sagecal_tpu_torch.ops import coh as coh_ops
    out = {}
    ptxas = ptxas_resources("coh")
    for F, per_channel, call in ((1, False, "solve"), (8, True, "residual")):
        args, n_gauss, fl = _coh_inputs(F, per_channel)
        step = coh_ops.channel_step(fl)
        uvw3, geom, flux, gauss, freqs, _ = args
        M, _, S = geom.shape
        B = uvw3.shape[1]
        abs_err, rel, err_kernel, err_plain = _coh_check(call, args, step)
        fn = lambda: coh_ops.coherencies_points(*args, step=step)
        ms = cuda_ms(fn, 20)
        dev_ms = device_ms(fn, 50)
        k_us = kernel_us(fn, ("coh_points",))
        if k_us is None:
            raise AssertionError(f"coh {call}: the profiler found no "
                                 "coh_points kernel")
        n_kernels, traces = kernels_per_call(fn, "coh_points",
                                             lambda: coh_ops.LAUNCHES)
        if n_kernels != 1:
            raise AssertionError(f"coh {call}: {n_kernels} kernels a call")
        plain_ms = cuda_ms(lambda: coh_ops.coherencies_points_plain(*args), 3)
        n_ops = coh_ops.op_count(M, F, B, S, n_gauss)
        n_bytes = 4 * (uvw3.numel() + geom.numel() + flux.numel()
                       + gauss.numel() + F + M * B * F * 8)
        bms, by = bound_ms(n_bytes, n_ops)
        rec = dict(call=call, M=M, F=F, B=B, S=S, n_gauss=n_gauss,
                   step=step, max_abs_err=abs_err, rel_err=rel,
                   f64_err_kernel=err_kernel, f64_err_plain_f32=err_plain,
                   ms=ms, device_ms=dev_ms, kernel_us=k_us,
                   kernels_per_call=n_kernels, kernel_traces=traces,
                   plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, library_ms=None,
                   kernel_bound_share=bms / (k_us / 1e3),
                   geometry=coh_ops.coh_geometry(F, B)._asdict(),
                   deterministic=True, ptxas=ptxas)
        if step is not None:
            # the same call by per-channel sincos (the uneven route)
            _, t_rel, t_err, _ = _coh_check(call + "_sincos", args, None)
            t_us = kernel_us(lambda: coh_ops.coherencies_points(*args),
                             ("coh_points",))
            if t_us is None:
                raise AssertionError(f"coh {call}: the profiler found no "
                                     "coh_points kernel (sincos)")
            rec.update(sincos_kernel_us=t_us, sincos_rel_err=t_rel,
                       sincos_f64_err_kernel=t_err)
        emit("coh", **rec)
        out[call] = rec
    cases = [(tag, F, S, _coh_edge_inputs, (F, S, kind, spacing),
              spacing == "uneven", True)
             for tag, F, S, kind, spacing in COH_EDGES]
    cases += [(tag, F, S, _coh_random_inputs, (F, S), False, vs_plain)
              for tag, F, S, vs_plain in COH_RANDOM]
    for tag, F, S, make, shape, uneven, vs_plain in cases:
        args, n_gauss, fl = make(*shape)
        step = coh_ops.channel_step(fl)
        if (step is None) != (uneven or F == 1):
            raise AssertionError(f"coh {tag}: channel_step gave {step}")
        abs_err, rel, err_kernel, err_plain = _coh_check(tag, args, step,
                                                         vs_plain)
        n_kernels, traces = kernels_per_call(
            lambda: coh_ops.coherencies_points(*args, step=step),
            "coh_points", lambda: coh_ops.LAUNCHES)
        if n_kernels != 1:
            raise AssertionError(f"coh {tag}: {n_kernels} kernels a call")
        rec = dict(tag=tag, F=F, S=S, B=args[0].shape[1],
                   M=args[1].shape[0], n_gauss=n_gauss, step=step,
                   max_abs_err=abs_err, rel_err=rel, vs_plain=vs_plain,
                   f64_err_kernel=err_kernel, f64_err_plain_f32=err_plain,
                   kernels_per_call=n_kernels, kernel_traces=traces,
                   deterministic=True)
        if step is not None:
            # the same inputs by per-channel sincos (the uneven route)
            _, t_rel, t_err, _ = _coh_check(tag + "_sincos", args, None,
                                            vs_plain)
            rec.update(sincos_rel_err=t_rel, sincos_f64_err_kernel=t_err)
        emit("coh_edge", **rec)
        out[tag] = dict(max_abs_err=abs_err)
    for tag, fl in COH_BANDS:
        out[tag] = _coh_band(tag, fl, ptxas)
    return out


#: the stochastic band shapes of e2e_stochastic (-M 4 -w 2 on 8 channels:
#: one minibatch of 30 timeslots, 4 evenly spaced channels a band) and of
#: a padded last band (-w 3 on 8 channels: channels 6, 7 and 6 again, an
#: uneven list, so the per-channel sincos path), with per-channel flux
COH_BANDS = (("band_F4", FREQS[:4]),
             ("band_F3_padded", FREQS[[6, 7, 6]]))
#: timeslots of e2e_stochastic's minibatch (-M 4 of 120)
BAND_TIMES = TILESZ // 4


def _coh_band(tag: str, fl, ptxas: dict) -> dict:
    """The coherency kernel at a stochastic band's shape (M = 8 clusters
    of 64 sources, a quarter gaussian; B = BAND_TIMES x 1891 rows; the
    band's channels ``fl`` with per-channel flux): against its plain
    version (1e-4) and float64, a bitwise repeat, one kernel a call, and
    its times and operation bound."""
    from sagecal_tpu_torch.ops import coh as coh_ops
    args, n_gauss, fl = _coh_inputs(len(fl), True, fl=np.asarray(fl),
                                    n_times=BAND_TIMES)
    step = coh_ops.channel_step(fl)
    if (step is None) != (len(set(fl)) != len(fl)):
        raise AssertionError(f"coh {tag}: channel_step gave {step}")
    uvw3, geom, flux, gauss, freqs, _ = args
    M, _, S = geom.shape
    F, B = len(fl), uvw3.shape[1]
    abs_err, rel, err_kernel, err_plain = _coh_check(tag, args, step)
    fn = lambda: coh_ops.coherencies_points(*args, step=step)
    k_us = kernel_us(fn, ("coh_points",))
    if k_us is None:
        raise AssertionError(f"coh {tag}: the profiler found no coh_points "
                             "kernel")
    n_kernels, traces = kernels_per_call(fn, "coh_points",
                                         lambda: coh_ops.LAUNCHES)
    if n_kernels != 1:
        raise AssertionError(f"coh {tag}: {n_kernels} kernels a call")
    n_ops = coh_ops.op_count(M, F, B, S, n_gauss)
    n_bytes = 4 * (uvw3.numel() + geom.numel() + flux.numel()
                   + gauss.numel() + F + M * B * F * 8)
    bms, by = bound_ms(n_bytes, n_ops)
    rec = dict(tag=tag, M=M, F=F, B=B, S=S, n_gauss=n_gauss,
               freqs=[float(f) for f in fl], step=step,
               geometry=coh_ops.coh_geometry(F, B)._asdict(),
               max_abs_err=abs_err, rel_err=rel, f64_err_kernel=err_kernel,
               f64_err_plain_f32=err_plain, ms=cuda_ms(fn, 20),
               device_ms=device_ms(fn, 50), kernel_us=k_us,
               kernels_per_call=n_kernels, kernel_traces=traces,
               plain_ms=cuda_ms(
                   lambda: coh_ops.coherencies_points_plain(*args), 3),
               bound_ms=bms, bound_by=by, library_ms=None,
               kernel_bound_share=bms / (k_us / 1e3), deterministic=True,
               registers=ptxas)
    emit("coh_band", **rec)
    return rec


def _sweep_inputs(K: int, seed: int = 2, N: int = N_STATIONS,
                  T: int = TILESZ, nchunk: int | None = None):
    """The sweep's inputs at the path's shapes: N stations, T timeslots,
    chunk ids of a cluster with ``nchunk`` hybrid chunks (default K)
    solved at kmax = K, as ``predict.chunk_indices`` makes them; chunks
    past nchunk, or past the timeslots, have no rows."""
    import torch
    dev = "cuda"
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    sta1 = torch.as_tensor(np.tile(p, T), device=dev)
    sta2 = torch.as_tensor(np.tile(q, T), device=dev)
    nck = K if nchunk is None else nchunk
    cid = torch.as_tensor(np.minimum((np.arange(B) // nb) // -(-T // nck),
                                     nck - 1), device=dev)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    coh = c64(rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2)))
    J = c64((rng.normal(size=(K, N, 2, 2))
             + 1j * rng.normal(size=(K, N, 2, 2))) * 0.2 + np.eye(2))
    x8 = f32(rng.normal(size=(B, 8)))
    wt = f32(rng.random((B, 8)) * (rng.random((B, 1)) > 0.05))
    cw = f32(rng.random((B, 8)))
    return (x8, J, coh, sta1, sta2, cid, wt, cw, nb, K), (B, nb)


#: edge shapes of the sweep and matvec phases: (tag, stations, timeslots,
#: kmax, the cluster's own chunk count). nb = 190 is not a multiple of the
#: kernel's 32-baseline tile (nor is 1891); "empty_chunk" is a 1-chunk
#: cluster solved at kmax = 2 (chunk 1 has no rows), "one_slot" one
#: timeslot at kmax = 2 (chunk 1 starts past it).
EDGES = (("nb190", 20, 5, 3, 3), ("empty_chunk", N_STATIONS, TILESZ, 2, 1),
         ("one_slot", N_STATIONS, 1, 2, 2))


#: the Jones modes of the constrained solves (``--jones diag|phase``) and
#: their block widths md: the sweep, visits and matvec kernels run at md
#: = 2 and 1 beside full Jones (md = 4)
MODES = (("diag", 2), ("phase", 1))


def _sweep_check(tag, args, nb, jones="full"):
    """The sweep kernel against its plain version on ``args`` in the Jones
    mode ``jones``, twice (bitwise equal), and an empty chunk's blocks
    exactly zero. Returns (relative errors per output, max |diff|, the
    first call's outputs)."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    x8, J, coh, sta1, sta2, cid, wt, cw, _, K = args
    n0 = swp.LAUNCHES
    got = swp.sweep_blocks(*args, jones=jones)
    again = swp.sweep_blocks(*args, jones=jones)
    torch.cuda.synchronize()
    if swp.LAUNCHES != n0 + 2:
        raise AssertionError(f"sweep {tag}: the wrapper did not launch once "
                             "a call")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"sweep {tag}: two calls differ")
    s1b, s2b = sta1[:nb], sta2[:nb]
    ref = swp.sweep_blocks_plain(x8, J[:, s1b], J[:, s2b], coh, cid, wt, cw,
                                 nb, jones)
    pairs = [rel_err(g, r) for g, r in zip(got, ref)]
    errs = dict(zip(("pp", "qq", "pq", "jtep", "jteq", "cost"),
                    (rel for _, rel in pairs)))
    bad = {k: v for k, v in errs.items() if not v <= KERNEL_RTOL}
    if bad:
        raise AssertionError(f"sweep kernel {tag}: {bad} > {KERNEL_RTOL}")
    if K > 1:
        for k in range(K):
            if not bool((cid == k).any()) and any(
                    bool(g[k].abs().max() > 0) for g in got):
                raise AssertionError(f"sweep {tag}: empty chunk {k} has "
                                     "non-zero blocks")
    return errs, max(a for a, _ in pairs), got


def _stored(args, policy: str):
    """The sweep's inputs ``args`` with their rows x8, wt and cost_wt in
    the storage dtype of ``policy`` (as they are at "f32")."""
    from sagecal_tpu_torch import dtypes
    st = dtypes.storage_dtype(policy)
    return tuple(a.to(st) if i in (0, 6, 7) else a
                 for i, a in enumerate(args))


def _sweep_timed(K: int, jones: str, ptxas: dict,
                 policy: str = "f32") -> dict:
    """The sweep kernel at full width (K chunks, Jones mode ``jones``,
    the rows in the storage dtype of ``policy``): checked against its
    plain version, one kernel a call, and timed as ``call_ms`` (one call,
    median CUDA-event time after a synchronize), ``device_ms`` (200
    back-to-back calls over the count) and the profiler's ``kernel_us``,
    beside its bound."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    from sagecal_tpu_torch.solvers import normal_eq as ne
    md = ne.jones_mdim(jones)
    args, (B, nb) = _sweep_inputs(K)
    args = _stored(args, policy)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, _ = args
    errs, abs_err, _ = _sweep_check(f"K={K} {jones} {policy}", args, nb,
                                    jones)
    call = lambda: swp.sweep_blocks(*args, jones=jones)
    ms = cuda_ms(call, 50)
    dev_ms = device_ms(call)
    k_us = kernel_us(call, ("sweep_cluster",))
    n_kernels, traces = kernels_per_call(call, "sweep_cluster",
                                         lambda: swp.LAUNCHES)
    if n_kernels != 1:
        raise AssertionError(f"sweep K={K} {jones}: {n_kernels} kernels a "
                             "call")
    s1b, s2b = sta1[:nb], sta2[:nb]
    plain_ms = cuda_ms(
        lambda: swp.sweep_blocks_plain(x8, J[:, s1b], J[:, s2b], coh, cid,
                                       wt, cw, nb, jones), 3)
    # rows (x, w, cw in the storage dtype, the complex64 coherency: 128
    # bytes a row at float32, 80 at bf16/f16), chunk ids (int32, as the
    # TPU kernel reads them) when K > 1, the Jones and the baselines'
    # stations (int32) read once; the caller layout of md and the costs
    # written once
    row_bytes = 3 * 8 * x8.element_size() + 8 * 4
    n_bytes = row_bytes * B + 4 * (B * (K > 1) + K * N_STATIONS * 8 + 2 * nb
                                   + K * nb * swp.n_out(md) + K)
    # each row enters the sums of its own chunk only
    n_rows = int(((cid >= 0) & (cid < K)).sum())
    bms, by = bound_ms(n_bytes, swp.sweep_flops_per_row(md) * n_rows)
    geo = swp.sweep_geometry(TILESZ, nb, K, swp._sweep_slots(
        torch.device("cuda", torch.cuda.current_device()), K, md,
        swp.STORAGE[x8.dtype][0]), md=md)
    rec = dict(K=K, jones=jones, md=md, policy=policy, row_bytes=row_bytes,
               T=TILESZ, nb=nb, rel_err=errs,
               max_abs_err=abs_err, ms=ms, call_ms=ms, device_ms=dev_ms,
               kernel_us=k_us, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=None, bound_share=bms / dev_ms,
               kernel_bound_share=k_us and bms / (k_us / 1e3),
               kernels_per_call=n_kernels, kernel_traces=traces,
               geometry=dict(tiles=geo.tiles, cluster=geo.cluster,
                             times=geo.times),
               deterministic=True, ptxas=ptxas)
    emit("sweep", **rec)
    return rec


def phase_sweep():
    """The fused sweep kernel against its plain version at full width (K =
    1 and 4) in each Jones mode (md = 4, 2, 1) and at the edge shapes
    (every edge in full Jones, the empty chunk in diag and phase too),
    each twice (bitwise equal); timed by :func:`_sweep_timed`. The bf16
    and f16 instances (``--dtype-policy``) likewise at K = 4 in each mode,
    checked at K = 1 and on the empty chunk. Records are keyed K (full
    Jones), (jones, K) and (policy, jones, K)."""
    out = {}
    ptxas = ptxas_resources("sweep")
    for K in (1, 4):
        out[K] = _sweep_timed(K, "full", ptxas)
    for jones, _ in MODES:
        for K in (1, 4):
            out[(jones, K)] = _sweep_timed(K, jones, ptxas)
    for policy in REDUCED:
        for jones in ("full",) + tuple(m for m, _ in MODES):
            out[(policy, jones, 4)] = _sweep_timed(4, jones, ptxas, policy)
        for tag, K, nck in (("K=1", 1, None), ("empty_chunk", 2, 1)):
            args, (B, nb) = _sweep_inputs(K, seed=6, nchunk=nck)
            errs, abs_err, _ = _sweep_check(f"{tag} {policy}",
                                            _stored(args, policy), nb)
            emit("sweep_edge", tag=tag, policy=policy, K=K, nchunk=nck,
                 rel_err=errs, max_abs_err=abs_err, deterministic=True)
            out[(policy, tag)] = dict(max_abs_err=abs_err)
    for tag, N, T, K, nck in EDGES:
        for jones in ("full",) + (tuple(m for m, _ in MODES)
                                  if tag == "empty_chunk" else ()):
            args, (B, nb) = _sweep_inputs(K, seed=6, N=N, T=T, nchunk=nck)
            errs, abs_err, _ = _sweep_check(f"{tag} {jones}", args, nb,
                                            jones)
            emit("sweep_edge", tag=tag, jones=jones, N=N, T=T, nb=nb, K=K,
                 nchunk=nck, rel_err=errs, max_abs_err=abs_err,
                 deterministic=True)
            out[(tag, jones)] = dict(max_abs_err=abs_err)
    return out


def _baseline_blocks(fac):
    """The [K, nb, 4 md, 4 md] baseline blocks [pp pq; pq^T qq] acting on
    (vp, vq), assembled once for the library-call yardstick."""
    K, nb, md = fac.pp.shape[0], fac.pp.shape[1], fac.pp.shape[-1]
    Bk = fac.pp.new_zeros((K, nb, 2, 2, md, 2, 2, md))  # [row s,a][col s,a]
    for a in range(2):
        Bk[:, :, 0, a, :, 0, a, :] = fac.pp[:, :, a]
        Bk[:, :, 1, a, :, 1, a, :] = fac.qq[:, :, a]
        for o in range(2):
            Bk[:, :, 0, a, :, 1, o, :] = fac.pq[:, :, a, o]
            Bk[:, :, 1, o, :, 0, a, :] = fac.pq[:, :, a, o].transpose(-1, -2)
    return Bk.reshape(K, nb, 4 * md, 4 * md).contiguous()


def _matvec_check(tag, fac, sta1, sta2, N, shift, gen):
    """The matvec kernel through a plan against its plain version, twice
    (bitwise equal), at the blocks' width md. Returns (v, plan, abs err,
    rel err)."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    K, nb, md = fac.pp.shape[0], fac.pp.shape[1], fac.pp.shape[-1]
    v = torch.randn((K, 2 * md * N), device="cuda", generator=gen,
                    dtype=torch.float32)
    # built once per tile on the main path (sagefit_host), the plan once
    # per Gram-block set (a tCG operator, a PCG solve)
    lists = swp.station_lists(sta1, sta2, nb, N)
    plan = swp.matvec_plan(fac, sta1, sta2, N, shift=shift, lists=lists)
    n0 = swp.MATVEC_LAUNCHES
    got = swp.matvec_apply(plan, v)
    again = swp.matvec_apply(plan, v)
    torch.cuda.synchronize()
    if swp.MATVEC_LAUNCHES != n0 + 2:
        raise AssertionError(f"matvec {tag}: the wrapper did not launch once "
                             "a call")
    if not torch.equal(got, again):
        raise AssertionError(f"matvec {tag}: two calls differ")
    ref = swp.gn_matvec_blocks_plain(fac, v, sta1[:nb].long(),
                                     sta2[:nb].long(), N, shift=shift)
    abs_err, rel = rel_err(got, ref)
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"matvec kernel {tag}: {rel:.3e} > "
                             f"{KERNEL_RTOL}")
    return v, plan, abs_err, rel


def _matvec_measure(tag: str, fac, sta1, sta2, N: int, gen,
                    ptxas: dict) -> dict:
    """The matvec kernel on the Gram blocks ``fac`` ([K, nb, ...], any
    md), checked against its plain version through :func:`_matvec_check`
    (twice, bitwise equal), one kernel a call by the profiler, and timed
    through a plan, as the solver loops call it, beside its bound and a
    library yardstick. Returns the record's figures."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    K, nb, md = fac.pp.shape[0], fac.pp.shape[1], fac.pp.shape[-1]
    shift = torch.rand((K,), device="cuda", generator=gen,
                       dtype=torch.float32) + 0.1
    v, plan, abs_err, rel = _matvec_check(tag, fac, sta1, sta2, N, shift,
                                          gen)
    s1b, s2b = sta1[:nb].long(), sta2[:nb].long()
    ref = swp.gn_matvec_blocks_plain(fac, v, s1b, s2b, N, shift=shift)
    Bk = _baseline_blocks(fac)
    nv = 2 * md

    def library():
        vr = v.reshape(K, N, nv)
        vg = torch.cat([vr[:, s1b], vr[:, s2b]], dim=-1)[..., None]
        yb = torch.matmul(Bk, vg)[..., 0]
        y = v.new_zeros((K, N, nv))
        y.index_add_(1, s1b, yb[..., :nv]).index_add_(1, s2b, yb[..., nv:])
        return y.reshape(K, nv * N) + shift[:, None] * v

    lib_err = rel_err(library(), ref)[1]
    if not lib_err <= KERNEL_RTOL:
        raise AssertionError(f"matvec yardstick disagrees: {lib_err}")
    call = lambda: swp.matvec_apply(plan, v)
    ms = cuda_ms(call, 200)
    dev_ms = device_ms(call)
    k_us = kernel_us(call, ("matvec_station",))
    n_kernels, traces = kernels_per_call(call, "matvec_station",
                                         lambda: swp.MATVEC_LAUNCHES)
    if n_kernels != 1:
        raise AssertionError(f"matvec {tag}: {n_kernels} kernels a call")
    plain_ms = cuda_ms(lambda: swp.gn_matvec_blocks_plain(
        fac, v, s1b, s2b, N, shift=shift), 50)
    library_ms = cuda_ms(library, 50)
    # blocks (8 md^2 words a (chunk, baseline)), v, the shift and the
    # baselines' stations (int32) read once, y written once
    n_bytes = 4 * (K * nb * 8 * md * md + 2 * K * N * nv + K + 2 * nb)
    bms, by = bound_ms(n_bytes, swp.matvec_flops_per_baseline(md) * K * nb
                       + 2 * K * N * nv)
    return dict(K=K, md=md, nb=nb, N=N, max_abs_err=abs_err, rel_err=rel,
                ms=ms, call_ms=ms, device_ms=dev_ms, kernel_us=k_us,
                kernels_per_call=n_kernels, kernel_traces=traces,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bound_share=bms / dev_ms,
                kernel_bound_share=k_us and bms / (k_us / 1e3),
                library_ms=library_ms, library_rel_err=lib_err,
                deterministic=True, ptxas=ptxas)


def _matvec_timed(K: int, jones: str, ptxas: dict) -> dict:
    """The matvec kernel on Gram blocks from a full-width sweep in the
    Jones mode ``jones`` (the layout the tCG and PCG loops hand it),
    measured by :func:`_matvec_measure`."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    args, (B, nb) = _sweep_inputs(K, seed=3)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, _ = args
    fac, _, _ = swp.gn_blocks(x8, J, coh, sta1, sta2, cid, wt, N_STATIONS,
                              K, nb, jones=jones)
    if swp._block_view(fac.pp, nb)[0] is not fac.pp:
        raise AssertionError("matvec: the sweep's records were copied")
    gen = torch.Generator(device="cuda").manual_seed(K)
    rec = dict(jones=jones, **_matvec_measure(
        f"K={K} {jones}", fac, sta1, sta2, N_STATIONS, gen, ptxas))
    emit("matvec", **rec)
    return rec


def _matvec_lanes(V: int, K: int, ptxas: dict) -> dict:
    """The matvec kernel at the shape of a batch of solve intervals: the
    multi-visit sweep's records of V visits of K chunks ([V K, nb, REC],
    every operand and the chunk ids per visit, visit v a cluster of
    max(1, K - v) chunks, as ``--tile-batch`` folds its tiles' visits) at
    full width in full Jones, measured by :func:`_matvec_measure`."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    args, (B, nb) = _visits_inputs(K, True, seed=12 + V, V=V, nchunk=K)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, _, _ = args
    lanes = swp.Lanes(V=V, K=K, cid=cid, tiles=V)
    fac, _, _ = swp.gn_blocks(
        x8.reshape(V * B, 8), J.reshape((V * K,) + tuple(J.shape[2:])),
        coh.reshape(V * B, 2, 2), sta1, sta2, cid, wt.reshape(V * B, 8),
        N_STATIONS, V * K, nb, lanes=lanes)
    if swp._block_view(fac.pq, nb)[0] is not fac.pq:
        raise AssertionError("matvec: the multi-visit records were copied")
    gen = torch.Generator(device="cuda").manual_seed(100 + V)
    rec = dict(V=V, K_visit=K, jones="full", **_matvec_measure(
        f"lanes V={V} K={K}", fac, sta1, sta2, N_STATIONS, gen, ptxas))
    emit("matvec_lanes", **rec)
    return rec


def phase_matvec():
    """The blocks matvec kernel against its plain version on Gram blocks
    from a full-width sweep in each Jones mode (K = 1 and 4), on a
    190-baseline layout and on the multi-visit sweep's [V K, nb, REC]
    records; twice each (bitwise equal), one kernel a call, timed by
    :func:`_matvec_timed`; and timed at a batch's shape, V = TILE_BATCH
    and N_LANES visits of 4 chunks (:func:`_matvec_lanes`). Records are
    keyed K (full Jones), (jones, K) and ("lanes", V)."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    out = {}
    ptxas = ptxas_resources("matvec")
    for K in (1, 4):
        out[K] = _matvec_timed(K, "full", ptxas)
    for jones, _ in MODES:
        for K in (1, 4):
            out[(jones, K)] = _matvec_timed(K, jones, ptxas)
    # a 190-baseline layout (not a multiple of 32), K = 3
    args, (B, nb) = _sweep_inputs(3, seed=7, N=20, T=5)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, K = args
    fac, _, _ = swp.gn_blocks(x8, J, coh, sta1, sta2, cid, wt, 20, K, nb)
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, _, abs_err, rel = _matvec_check("nb190", fac, sta1, sta2, 20, None,
                                       gen)
    emit("matvec_edge", tag="nb190", N=20, nb=nb, K=K, max_abs_err=abs_err,
         rel_err=rel, deterministic=True)
    out["nb190"] = dict(max_abs_err=abs_err)
    # the multi-visit sweep's records, folded as a group's lanes, in each
    # Jones mode
    vargs, (B, nb) = _visits_inputs(2, True, seed=8)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, K, V = vargs
    lanes = swp.Lanes(V=V, K=K, cid=cid)
    for jones in ("full",) + tuple(m for m, _ in MODES):
        fac, _, _ = swp.gn_blocks(x8.reshape(V * B, 8), J.reshape(
            (V * K,) + tuple(J.shape[2:])), coh.reshape(V * B, 2, 2), sta1,
            sta2, cid, wt.reshape(V * B, 8), N_STATIONS, V * K, nb,
            jones=jones, lanes=lanes)
        if swp._block_view(fac.pq, nb)[0] is not fac.pq:
            raise AssertionError("matvec: the multi-visit records were "
                                 "copied")
        shift = torch.rand((V * K,), device="cuda", generator=gen) + 0.1
        _, _, abs_err, rel = _matvec_check(f"visits {jones}", fac, sta1,
                                           sta2, N_STATIONS, shift, gen)
        emit("matvec_edge", tag="visits", jones=jones, V=V, K=K, nb=nb,
             max_abs_err=abs_err, rel_err=rel, deterministic=True)
        out[("visits", jones)] = dict(max_abs_err=abs_err)
    # the batch's tCG products: e2e_tile_batch's TILE_BATCH lanes and a
    # batch of N_LANES
    for V in (TILE_BATCH, N_LANES):
        out[("lanes", V)] = _matvec_lanes(V, 4, ptxas)
    return out


def _visits_inputs(K: int, batched_wt: bool, seed: int = 4,
                   V: int = N_VISITS, N: int = N_STATIONS, T: int = TILESZ,
                   nchunk: int | None = None):
    """V visits at the path's shapes (by default those of e2e_inflight's
    groups): data, Jones and coherencies per visit, the weights per visit
    or shared. With ``nchunk`` the chunk ids are per visit: visit v a
    cluster of max(1, nchunk - v) chunks solved at kmax = K; else one
    shared array (clusters of equal chunk counts). The ids are int64, as
    a group's lanes hold them."""
    import torch
    dev = "cuda"
    rng = np.random.default_rng(seed)
    p, q = np.triu_indices(N, k=1)
    nb = len(p)
    B = T * nb
    sta1 = torch.as_tensor(np.tile(p, T), device=dev)
    sta2 = torch.as_tensor(np.tile(q, T), device=dev)
    rows = np.arange(B) // nb

    def ids(nck):
        return np.minimum(rows // -(-T // nck), nck - 1)

    cid = torch.as_tensor(
        ids(K) if nchunk is None
        else np.stack([ids(max(1, nchunk - v)) for v in range(V)]),
        dtype=torch.int64, device=dev)
    c64 = lambda a: torch.as_tensor(a, dtype=torch.complex64, device=dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    wshape = (V, B, 8) if batched_wt else (B, 8)
    coh = c64(rng.normal(size=(V, B, 2, 2))
              + 1j * rng.normal(size=(V, B, 2, 2)))
    J = c64((rng.normal(size=(V, K, N, 2, 2))
             + 1j * rng.normal(size=(V, K, N, 2, 2))) * 0.2 + np.eye(2))
    x8 = f32(rng.normal(size=(V, B, 8)))
    wt = f32(rng.random(wshape) * (rng.random(wshape[:-1] + (1,)) > 0.05))
    cw = f32(rng.random(wshape))
    return (x8, J, coh, sta1, sta2, cid, wt, cw, nb, K, V), (B, nb)


def _visits_check(tag, args, jones="full"):
    """The multi-visit sweep against its plain version on ``args`` in the
    Jones mode ``jones``, twice (one launch a call, bitwise equal), and
    each empty (visit, chunk)'s blocks exactly zero. Returns (relative
    errors per output, max |diff|)."""
    import torch
    from sagecal_tpu_torch.ops import sweep as swp
    x8, J, coh, sta1, sta2, cid, wt, cw, nb, K, V = args
    n0 = swp.VISITS_LAUNCHES
    got = swp.sweep_blocks_visits(*args, jones=jones)
    again = swp.sweep_blocks_visits(*args, jones=jones)
    torch.cuda.synchronize()
    if swp.VISITS_LAUNCHES != n0 + 2:
        raise AssertionError(f"visits {tag}: the wrapper did not launch once "
                             "a call")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"visits {tag}: two calls differ")
    s1b, s2b = sta1[:nb], sta2[:nb]
    ref = swp.sweep_blocks_visits_plain(x8, J[:, :, s1b], J[:, :, s2b], coh,
                                        cid, wt, cw, nb, V, jones)
    pairs = [rel_err(g, r) for g, r in zip(got, ref)]
    errs = dict(zip(("pp", "qq", "pq", "jtep", "jteq", "cost"),
                    (rel for _, rel in pairs)))
    bad = {k: v for k, v in errs.items() if not v <= KERNEL_RTOL}
    if bad:
        raise AssertionError(f"visits kernel {tag}: {bad} > {KERNEL_RTOL}")
    vcid = cid if cid.dim() == 2 else cid.expand(V, -1)
    for v in range(V):
        for k in range(K):
            if K > 1 and not bool((vcid[v] == k).any()) and any(
                    bool(g[v, k].abs().max() > 0) for g in got):
                raise AssertionError(f"visits {tag}: empty chunk {k} of "
                                     f"visit {v} has non-zero blocks")
    return errs, max(a for a, _ in pairs)


#: the visits phase's edge shapes: EDGES at V = 3 (a ragged group of a
#: width-4 sweep), each visit with its own chunk ids
N_RAGGED = 3


def _visits_timed(K: int, batched_wt: bool, jones: str, ptxas: dict,
                  serial: bool, policy: str = "f32") -> dict:
    """The multi-visit sweep at V = 4 visits of the full-width path in
    the Jones mode ``jones``, the rows in the storage dtype of
    ``policy``, checked against its plain version, one kernel a call,
    timed as the sweep is (and, with ``serial``, against V serial
    sweep-kernel calls)."""
    from sagecal_tpu_torch.ops import sweep as swp
    from sagecal_tpu_torch.solvers import normal_eq as ne
    md = ne.jones_mdim(jones)
    args, (B, nb) = _visits_inputs(K, batched_wt)
    args = _stored(args, policy)
    x8, J, coh, sta1, sta2, cid, wt, cw, _, _, V = args
    errs, abs_err = _visits_check(
        f"K={K} batched_wt={batched_wt} {jones} {policy}", args, jones)
    s1b, s2b = sta1[:nb], sta2[:nb]
    plain = lambda: swp.sweep_blocks_visits_plain(
        x8, J[:, :, s1b], J[:, :, s2b], coh, cid, wt, cw, nb, V, jones)
    wv = (lambda a, v: a[v]) if batched_wt else (lambda a, v: a)

    def serial_calls():
        return [swp.sweep_blocks(x8[v], J[v], coh[v], sta1, sta2, cid,
                                 wv(wt, v), wv(cw, v), nb, K, jones=jones)
                for v in range(V)]

    call = lambda: swp.sweep_blocks_visits(*args, jones=jones)
    ms = cuda_ms(call, 50)
    dev_ms = device_ms(call)
    k_us = kernel_us(call, ("sweep_cluster",))
    n_kernels, traces = kernels_per_call(call, "sweep_cluster",
                                         lambda: swp.VISITS_LAUNCHES)
    if n_kernels != 1:
        raise AssertionError(f"visits K={K} {jones}: {n_kernels} kernels a "
                             "call")
    serial_ms = cuda_ms(serial_calls, 50) if serial else None
    plain_ms = cuda_ms(plain, 3)
    # per-visit operands read once per visit, shared ones once: x (8 in
    # the storage dtype), the coherency (8 words), the weights (8 + 8 in
    # the storage dtype) a row, the chunk id (int32) when K > 1; the
    # Jones and the baselines' stations (int32) read once; the caller
    # layout of md and the costs written once
    isz = x8.element_size()
    row_bytes = V * (8 * isz + 32) + (V if batched_wt else 1) * 16 * isz \
        + 4 * (K > 1) * (V if cid.dim() == 2 else 1)
    n_bytes = row_bytes * B + 4 * (V * K * N_STATIONS * 8 + 2 * nb
                                   + V * K * (nb * swp.n_out(md) + 1))
    n_rows = V * int(((cid >= 0) & (cid < K)).sum())
    bms, by = bound_ms(n_bytes, swp.sweep_flops_per_row(md) * n_rows)
    geo = swp.sweep_geometry(TILESZ, nb, K, swp._sweep_slots(
        x8.device, K, md, swp.STORAGE[x8.dtype][0]), V, md=md)
    rec = dict(V=V, K=K, jones=jones, md=md, policy=policy, T=TILESZ, nb=nb,
               batched_wt=batched_wt, rel_err=errs, max_abs_err=abs_err,
               ms=ms, call_ms=ms, device_ms=dev_ms, kernel_us=k_us,
               kernels_per_call=n_kernels, kernel_traces=traces,
               serial_ms=serial_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=None, bound_share=bms / dev_ms,
               kernel_bound_share=k_us and bms / (k_us / 1e3),
               geometry=dict(tiles=geo.tiles, cluster=geo.cluster,
                             times=geo.times),
               deterministic=True, ptxas=ptxas)
    emit("visits", **rec)
    return rec


def phase_visits():
    """The multi-visit sweep (the sweep kernel's visit axis) against its
    plain version, at V = 4 visits of the full-width path (the groups of
    e2e_inflight): in full Jones with the weights shared (plain LM, RTR)
    and per visit (robust weights), in diag and phase with the weights
    per visit; and at the edge shapes at V = 3 (the empty chunk in every
    mode), each twice (bitwise equal); timed by :func:`_visits_timed`,
    full Jones also against V serial sweep-kernel calls. The bf16 and f16
    instances likewise at K = 4 in each mode (weights per visit, as the
    robust solves of e2e_f16_inflight hold them), checked on the empty
    chunk at V = 3. Records are keyed (K, batched_wt) (full Jones),
    (jones, K) and (policy, jones, K)."""
    out = {}
    ptxas = ptxas_resources("sweep")
    for K in (1, 4):
        for batched_wt in (False, True):
            out[(K, batched_wt)] = _visits_timed(K, batched_wt, "full",
                                                 ptxas, True)
    for jones, _ in MODES:
        for K in (1, 4):
            out[(jones, K)] = _visits_timed(K, True, jones, ptxas, False)
    for policy in REDUCED:
        for jones in ("full",) + tuple(m for m, _ in MODES):
            out[(policy, jones, 4)] = _visits_timed(4, True, jones, ptxas,
                                                    False, policy)
        args, (B, nb) = _visits_inputs(2, False, seed=9, V=N_RAGGED,
                                       nchunk=1)
        errs, abs_err = _visits_check(f"empty_chunk {policy}",
                                      _stored(args, policy))
        emit("visits_edge", tag="empty_chunk", policy=policy, V=N_RAGGED,
             K=2, nchunk=1, rel_err=errs, max_abs_err=abs_err,
             deterministic=True)
        out[(policy, "empty_chunk")] = dict(max_abs_err=abs_err)
    for tag, N, T, K, nck in EDGES:
        for jones in ("full",) + (tuple(m for m, _ in MODES)
                                  if tag == "empty_chunk" else ()):
            args, (B, nb) = _visits_inputs(K, False, seed=9, V=N_RAGGED,
                                           N=N, T=T, nchunk=nck)
            errs, abs_err = _visits_check(f"{tag} {jones}", args, jones)
            emit("visits_edge", tag=tag, jones=jones, V=N_RAGGED, N=N, T=T,
                 nb=nb, K=K, nchunk=nck, rel_err=errs, max_abs_err=abs_err,
                 deterministic=True)
            out[(tag, jones)] = dict(max_abs_err=abs_err)
    out["tile_batch"] = _visits_lanes()
    return out


def _visits_lanes() -> dict:
    """The multi-visit sweep at the shape of a batch of solve intervals
    with groups: V = N_LANES visits, every operand and the chunk ids per
    visit (visit v a cluster of max(1, 4 - v) chunks at kmax = 4), md =
    4, at full width; checked against its plain version (twice, bitwise
    equal) and timed."""
    from sagecal_tpu_torch.ops import sweep as swp
    args, (B, nb) = _visits_inputs(4, True, seed=11, V=N_LANES, nchunk=4)
    errs, abs_err = _visits_check(f"V={N_LANES} per-visit chunk ids", args)
    call = lambda: swp.sweep_blocks_visits(*args)
    rec = dict(V=N_LANES, K=4, nchunk=4, T=TILESZ, nb=nb, rel_err=errs,
               max_abs_err=abs_err, call_ms=cuda_ms(call, 20),
               device_ms=device_ms(call, 50), deterministic=True)
    emit("visits_lanes", **rec)
    return rec


def _counts():
    from sagecal_tpu_torch.ops import coh, sweep
    from sagecal_tpu_torch.solvers import lm
    return {"coh": coh.LAUNCHES,
            "coh_by_f": {f"F{F}": n for F, n in sorted(coh.F_LAUNCHES.items())},
            "sweep": sweep.LAUNCHES,
            "matvec": sweep.MATVEC_LAUNCHES, "visits": sweep.VISITS_LAUNCHES,
            "xla_solves": lm.XLA_SOLVES,
            "by_md": {f"{k}_md{md}": n
                      for (k, md), n in sorted(sweep.MD_LAUNCHES.items())},
            "by_st": {f"{k}_{st}": n
                      for (k, st), n in sorted(sweep.ST_LAUNCHES.items())}}


def _reset():
    from sagecal_tpu_torch.ops import coh, sweep
    from sagecal_tpu_torch.solvers import lm
    coh.reset_launches()
    sweep.reset_launches()
    lm.reset_xla_solves()


#: the kernels the XLA assembly never launches
SOLVE_KERNELS = ("sweep", "matvec", "visits")


def _md_of(flags) -> int:
    """The block width md of a run's ``--jones`` flag (4 without it)."""
    from sagecal_tpu_torch.solvers import normal_eq as ne
    return ne.jones_mdim(flags[flags.index("--jones") + 1]) \
        if "--jones" in flags else 4


def _beam_of(flags) -> int:
    """The ``-B`` mode of a run's flags (0 without it)."""
    return int(flags[flags.index("-B") + 1]) if "-B" in flags else 0


def _policy_of(flags) -> str:
    """The storage policy of a run's ``--dtype-policy`` flag ("f32"
    without it)."""
    return flags[flags.index("--dtype-policy") + 1] \
        if "--dtype-policy" in flags else "f32"


def _spread_gated(tag: str, flags) -> bool:
    """Whether slice_parity's run ``tag`` is gated by the spreads
    (SPREAD_REPS): its CPU reference computes in float32, as the card."""
    return _policy_of(flags) != "f32" or tag in SPREAD_F32_RUNS


def _check_route(tag: str, launches: dict, must, xla: bool,
                 md: int = 4, policy: str = "f32") -> None:
    """Raise unless every kernel in ``must`` launched, every sweep,
    matvec and visits launch at the run's block width ``md`` (its Jones
    mode), every sweep and visits launch at the run's storage ``policy``
    (its instance of the kernel), and, on the XLA route (``xla``), every
    solve took the XLA assembly and no sweep, matvec or visits kernel
    launched."""
    if not all(launches[k] for k in must):
        raise AssertionError(f"{tag}: a kernel never launched: {launches}")
    if any(not key.endswith(f"_md{md}") for key in launches["by_md"]):
        raise AssertionError(f"{tag}: a solve kernel launched at another "
                             f"block width than md = {md}: {launches}")
    if any(not key.endswith(f"_{policy}") for key in launches["by_st"]):
        raise AssertionError(f"{tag}: a sweep instance of another storage "
                             f"dtype than {policy} launched: {launches}")
    if xla and (any(launches[k] for k in SOLVE_KERNELS)
                or not launches["xla_solves"]):
        raise AssertionError(f"{tag}: the XLA route launched a solve "
                             f"kernel or counted no XLA solve: {launches}")
    if not xla and launches["xla_solves"]:
        raise AssertionError(f"{tag}: the sweep route slid to the XLA "
                             f"assembly: {launches}")


#: slice_parity runs: (tag, stations, chunks per cluster, CLI solver
#: flags, kernels that must launch on the card). The default -j (5) runs
#: as mode 3 (OS-LM under Cholesky) at 16 stations, on single-chunk
#: clusters: with a 2-chunk cluster the first OS subset holds no row of
#: chunk 1, the reference seeds its damping at 1e-33, and one ulp of data
#: already moves the float64 reference's own J by ~3e-6 (the CPU tests
#: ``*_two_chunks_within_reference_spread``), so float32 runs land up to
#: 2e-2 from float64. At 41 stations (above the LMCUT downgrade) the
#: default is robust RTR with the dense --inner chol operator
#: (``default_rtr``); ``j5_cg`` runs it with the matvec kernel.
#: The inflight runs solve 8 clusters (groups of 2 survive the M//4
#: clamp) in groups through the multi-visit sweep kernel, on 41 stations.
#: At 16 stations and -g 10, -j 1 read 1.5e-3 from float64 in 1 of 3 card
#: runs (tile 1's starting residual: tile 0's J after capped LM runs
#: carries the roundoff of its trajectory); more stations and -g 30 (LM
#: runs nearer convergence) make the result depend less on the path. The
#: RTR one read 2.2e-3 at -e 1 (tile 0 stops far from convergence) and
#: 1.2-1.6e-4 at -e 2.
#: The XLA-route runs take the mixed sky (every morphology: the split
#: predict) at 41 stations: ``xla_default`` is the JAX CLI's default
#: command line (robust RTR, --inner chol, --kernel xla), ``xla_cg`` its
#: --inner cg (each tCG product one gn_matvec pass), and ``kmax5`` a
#: cluster of 5 hybrid chunks with no --kernel flag, which the fused
#: sweep cannot take: the XLA fallback (since PR 15 at 16 stations, -j 1
#: -g 30, where it ran robust RTR at 41: 26 s of the card's serial runs
#: and 83 s of CPU went to the consensus runs). Each tuple ends with
#: ``mixed``.
#: The constrained Jones modes: ``diag_j1`` (-j 1 --jones diag, the sweep
#: kernel at md = 2), ``phase_cg`` (-j 5 --inner cg --jones phase: the
#: sweep and matvec kernels at md = 1) and ``diag_inflight_rtr`` (groups
#: through the visits kernel and the matvec at md = 2).
#: Batches of solve intervals (--tile-batch 2, tile 0 alone): ``tile_
#: batch_rtr`` (j5_cg's solver on 3 tiles: the visits kernel at one visit
#: a tile and the matvec at 2 kmax chunks) and ``tile_batch_inflight``
#: (inflight_j1's groups on 3 tiles: 2 x 2 lanes a group step; its CPU
#: reference is among the longest of the phase, ~370 s on 4 tiles).
#: Since PR 16 inflight_j1, tile_batch_inflight and diag_inflight_rtr run
#: at -e 1 (tile 0's 6 EM iterations, not 12), which halves their CPU
#: references (~160 -> 84 s, 182 -> 98 s, 106 -> 58 s on one CPU core):
#: float32 alone then moves them 7.5e-5, 8.9e-5 and 3.9e-7 from float64
#: on the CPU, as at -e 2 (7.6e-5, 7.6e-5, 3.7e-7); inflight_rtr at -e 1
#: 1.9e-3 (1.1e-4 at -e 2), so the RTR runs on full Jones keep -e 2
#: (tools_dev/torch_parity_float32.py).
PARITY_RUNS = (("j1", 16, (1, 2, 1), ["-j", "1"], ("coh", "sweep"), False),
               ("default", 16, (1, 1, 1), [], ("coh", "sweep"), False),
               ("default_rtr", 41, (1, 2, 1), [], ("coh", "sweep"), False),
               ("j5_cg", 41, (1, 2, 1), ["-j", "5", "--inner", "cg"],
                ("coh", "sweep", "matvec"), False),
               ("inflight_j1", 41, (1, 2, 1, 1, 2, 1, 1, 1),
                ["-j", "1", "--inflight", "2", "-g", "30", "-e", "1"],
                ("coh", "visits"), False),
               ("inflight_rtr", 41, (1, 2, 1, 1, 2, 1, 1, 1),
                ["-j", "5", "--inner", "cg", "--inflight", "2"],
                ("coh", "visits", "matvec"), False),
               ("xla_default", 41, (1, 2, 1), ["-j", "5", "--kernel", "xla"],
                ("coh",), True),
               ("xla_cg", 41, (1, 2, 1),
                ["-j", "5", "--inner", "cg", "--kernel", "xla"], ("coh",),
                True),
               ("kmax5", 16, (1, 5, 1), ["-j", "1", "-g", "30"], ("coh",),
                False),
               ("diag_j1", 16, (1, 2, 1), ["-j", "1", "--jones", "diag"],
                ("coh", "sweep"), False),
               ("phase_cg", 41, (1, 2, 1),
                ["-j", "5", "--inner", "cg", "--jones", "phase"],
                ("coh", "sweep", "matvec"), False),
               ("diag_inflight_rtr", 41, (1, 2, 1, 1, 2, 1, 1, 1),
                ["-j", "5", "--inner", "cg", "--inflight", "2", "--jones",
                 "diag", "-e", "1"], ("coh", "visits", "matvec"), False),
               ("tile_batch_rtr", 41, (1, 2, 1),
                ["-j", "5", "--inner", "cg", "--tile-batch", "2"],
                ("coh", "sweep", "visits", "matvec"), False),
               ("tile_batch_inflight", 41, (1, 2, 1, 1, 2, 1, 1, 1),
                ["-j", "1", "--tile-batch", "2", "--inflight", "2", "-g",
                 "30", "-e", "1"], ("coh", "visits"), False),
               ("bandpass", 16, (1, 2, 1), ["-j", "1", "-g", "30", "-b", "1"],
                ("coh", "sweep"), False),
               ("whiten_phase", 16, (1, 2, 1),
                ["-j", "1", "-g", "30", "-W", "1", "-J", "1", "-k", "1"],
                ("coh", "sweep"), False),
               ("warm", 16, (1, 2, 1), ["-j", "1", "-g", "30", "-q", "@warm"],
                ("coh", "sweep"), False),
               ("sim", 16, (1, 2, 1),
                ["-a", "2", "-p", "@warm", "-z", "@ignore"], ("coh",),
                False),
               ("bf16_default", 16, (1, 1, 1), ["--dtype-policy", "bf16"],
                ("coh",), False),
               ("f16_j1_xla", 16, (1, 2, 1),
                ["-j", "1", "--kernel", "xla", "--dtype-policy", "f16"],
                ("coh",), True),
               ("f16_j1", 16, (1, 2, 1), ["-j", "1", "--dtype-policy", "f16"],
                ("coh", "sweep"), False),
               ("bf16_inflight_rtr", 41, (1, 2, 1, 1, 2, 1, 1, 1),
                ["-j", "5", "--inner", "cg", "--inflight", "2",
                 "--dtype-policy", "bf16"], ("coh", "visits", "matvec"),
                False),
               ("beam_array", 16, (1, 2, 1),
                ["-j", "1", "-g", "30", "-B", "1"], ("sweep",), False),
               ("beam_full", 16, (1, 1, 1), ["-B", "2"], ("sweep",), False),
               ("beam_full_t10", 16, (1, 1, 1), ["-B", "2"], ("sweep",),
                False),
               ("beam_element_tile_batch", 16, (1, 2, 1),
                ["-j", "5", "--inner", "cg", "-B", "3", "--tile-batch", "2"],
                ("sweep", "visits", "matvec"), False),
               ("multims", 16, (1, 2, 1), ["-j", "1", "-f", "@list"],
                ("coh", "sweep"), False),
               ("resume", 16, (1, 2, 1), ["-j", "1", "-p", "@sol"],
                ("coh", "sweep"), False))
#: Input, restart and the beam, on 16 stations at the float32
#: gate: the beam runs (BEAM_RUNS) on observations simulated through
#: their own beam mode from their stored beam.npz (BEAM_OBS: 20
#: timeslots a tile), the sky predicted through the generic route (no
#: coherency kernel); ``beam_full`` at the default mode on single-chunk
#: clusters, as ``default``, and ``beam_array`` at -g 30, as the other
#: -j 1 runs that need LM near convergence. At the parity observation's
#: 10 timeslots, float32 arithmetic alone moves these runs from float64
#: by 1.2e-3 to 4.0e-3 on the CPU as on the card (ROADMAP C11,
#: tests/test_torch_beam_float32.py); at 20 timeslots (beam_array at -g
#: 30) by <= 4.6e-5 (tools_dev/torch_beam_float32.py, on a CPU).
#: ``beam_full_t10`` holds the beam path at 10 timeslots all the same:
#: against the port's CPU run in float32 (SPREAD_F32_RUNS), gated by the
#: spreads as the reduced runs are.
#: ``multims`` a ``-f`` list of
#: two 2-channel subbands (MULTIMS_PARTS; the upper one with a tenth of
#: its channels flagged, so the merged tile goes through the native
#: packer); ``resume`` on 3 tiles, the card run killed at tile 1 and
#: resumed, held against the CPU's uninterrupted run
BEAM_RUNS = ("beam_array", "beam_full", "beam_element_tile_batch",
             "beam_full_t10")
BEAM_OBS = {"beam_array": (20, 0.02), "beam_full": (20, 0.02),
            "beam_element_tile_batch": (20, 0.02),
            "beam_full_t10": (10, 0.02)}
#: float32 runs whose CPU reference computes in float32 too, gated by the
#: spreads (SPREAD_REPS)
SPREAD_F32_RUNS = ("beam_full_t10",)
#: beam_stochastic's timeslots a tile: at STOCHASTIC_PARITY's 20 the
#: float32 run lies 1.2e-3 (residuals) and 1.9e-3 (solutions) from
#: float64 on the CPU as on the card (C11); at 40, 6.5e-6 and 1.5e-5
BEAM_STOCHASTIC_TIMES = 40
MULTIMS_PARTS = (("sb_a.ms", 0.0), ("sb_b.ms", 0.1))
#: The solve and correction options (-g 30, as the in-flight runs, to
#: keep -j 1 near convergence at 16 stations): ``bandpass`` (-b 1: the
#: joint solve, then one LBFGS fit a channel; the channels' res_0/res_1
#: are gated too), ``whiten_phase`` (-W 1 -J 1 -k 1: the 2-chunk
#: cluster's phases correct the residual), ``warm`` (-q from
#: :func:`write_option_files`' solutions) and ``sim`` (-a 2 -p of the same
#: file -z cluster 1: no solve). COLUMN_RUNS also hold their written
#: columns, card against CPU, within their gate.
#: tiles of a parity run's observation (2 unless named): the batches of
#: 2 after the solo tile 0. Six 41-station runs solve tile 0 only (the
#: cold tile): their second tile took ~60 s of the card's serial runs on
#: an NVIDIA H100 80GB HBM3 host (700.00 W), which bound slice_parity
#: (the MPI CLI plan runs take ~45 s); the warm start of tile 1 stays held by
#: inflight_j1, phase_cg, bf16_inflight_rtr, the tile-batch runs and every
#: 16-station run
PARITY_TILES = {"tile_batch_rtr": 3, "tile_batch_inflight": 3,
                "beam_element_tile_batch": 3, "resume": 3,
                "default_rtr": 1, "j5_cg": 1, "inflight_rtr": 1,
                "xla_default": 1, "xla_cg": 1, "diag_inflight_rtr": 1,
                "consensus_rtr_inflight": 1, "consensus_blocked": 1,
                "consensus_time_shard": 3}
#: The 41-station robust-RTR runs (-j 5) solve tiles of 5 timeslots
#: (timeslots a tile, noise), which shortens their CPU references,
#: slice_parity's longest part, by a third (532 -> 359 s on one CPU core
#: for the seven): float32 alone then moves them 1.1e-5 to 1.5e-4 from
#: float64 on the CPU, against 7.7e-6 to 1.1e-4 at 10
#: (tools_dev/torch_parity_float32.py --times 5 / 10)
RTR_OBS = {tag: (5, 0.02) for tag in ("default_rtr", "j5_cg", "inflight_rtr",
                                      "xla_default", "xla_cg", "phase_cg",
                                      "tile_batch_rtr")}
#: The reduced storage policies (--dtype-policy, against the port's CPU
#: run at the same policy, which computes in float32 there too):
#: ``bf16_default`` (the default mode on single-chunk clusters: its OS
#: iterations take the reduced OS fast path, dense equations of each
#: subset's rows and LU, and no sweep kernel), ``f16_j1_xla`` (the
#: reduced XLA assembly and LU), ``f16_j1`` (the f16 sweep instance) and
#: ``bf16_inflight_rtr`` (inflight_rtr's groups: the bf16 visits instance
#: and the matvec). Each also runs on the CPU with every source flux one
#: float32 ulp up (:func:`perturb_sky`); its gate is max(PARITY_RTOL,
#: SPREAD_FACTOR x that run's spread), at most SPREAD_CAP, and every
#: relaxation decision must agree. And each runs on the CPU without the
#: policy (float64 there): the card's and the CPU's reduced res_1 lie
#: within ENVELOPE of that run's on every tile.
#: Their observations (REDUCED_OBS: timeslots a tile, noise) are not the
#: float32 runs': at the parity observation's 10 timeslots and noise
#: 0.02 the bf16 rounding of data and model is not small against the
#: noise, and a one-ulp flux move shifts bf16_default's res_1 by 2.9e-1
#: on the CPU (the JAX package's bf16 run moves alike and lands 24-30%
#: above float32, outside its own envelope: ROADMAP C10). At
#: tests/test_dtype_policy.py's noise (0.05) and 120 timeslots the
#: spread is 1.5e-4 (bf16_default), at 60 timeslots 6.1e-5 and 1.3e-4
#: (f16_j1_xla, f16_j1), and at 10 timeslots on 41 stations 4.3e-4
#: (bf16_inflight_rtr), the bf16 runs within 1.8% and 4.6% of float32
#: (tools_dev/torch_reduced_spread.py, on a CPU).
REDUCED_OBS = {"bf16_default": (120, 0.05), "f16_j1_xla": (60, 0.05),
               "f16_j1": (60, 0.05), "bf16_inflight_rtr": (10, 0.05)}
#: the parity runs whose written column is gated, and their gate
COLUMN_RUNS = {"bandpass": PARITY_RTOL, "whiten_phase": PARITY_RTOL,
               "warm": PARITY_RTOL, "sim": SIM_RTOL, "multims": PARITY_RTOL}


def write_option_files(ms: str, seed: int = 11) -> dict:
    """Beside an observation ``ms`` (of :func:`make_observation`): the
    ``-q``/``-p`` solutions (one interval of near-identity Jones, not the
    observation's) and the ``-z`` list (cluster 1). Returns placeholder
    -> path, for :func:`_resolve`."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    work = os.path.dirname(ms)
    meta = ds.SimMS(ms).meta
    sky = skymodel.read_sky_cluster(
        os.path.join(work, "sky.txt"), os.path.join(work, "sky.txt.cluster"),
        meta["ra0"], meta["dec0"], meta["freq0"])
    J = ds.random_jones(sky.n_clusters, sky.nchunk, meta["n_stations"],
                        seed=seed, scale=0.1)
    files = {"@warm": os.path.join(work, "warm.sol"),
             "@ignore": os.path.join(work, "ignore.txt")}
    with sol.SolutionWriter(files["@warm"], meta["freq0"], meta["fdelta"],
                            1.0, meta["n_stations"], sky.n_clusters,
                            sky.n_eff_clusters) as w:
        w.write_interval(J, sky.nchunk)
    with open(files["@ignore"], "w") as f:
        f.write("1\n")
    return files


def _resolve(flags, ms: str):
    """``flags`` with the placeholders of :func:`write_option_files` made
    the paths beside ``ms``; ``@list`` (the ``-f`` list of a multims run)
    and ``@sol`` (a resume run's solutions) are the CPU copy's own for
    ``ms`` ending in ``.cpu``."""
    own = ".cpu" if ms.endswith(".cpu") else ""
    names = {"@warm": "warm.sol", "@ignore": "ignore.txt",
             "@list": "parts.list" + own, "@sol": "solutions.txt" + own}
    return [os.path.join(os.path.dirname(ms), names[f]) if f in names
            else f for f in flags]


def perturb_sky(sky: str) -> str:
    """A copy of the sky file ``sky`` (``sky + '.ulp'``) with every
    source's Stokes I moved up by one float32 ulp: a perturbation at the
    float32 roundoff of the model, whose effect on a run is the run's own
    spread."""
    out = []
    with open(sky) as f:
        for ln in f.read().splitlines():
            fields = ln.split()
            if len(fields) > 8 and not ln.startswith("#"):
                v = np.float32(float(fields[7]))
                fields[7] = repr(float(np.nextafter(v, np.float32(np.inf))))
                ln = " ".join(fields)
            out.append(ln)
    with open(sky + ".ulp", "w") as f:
        f.write("\n".join(out) + "\n")
    return sky + ".ulp"


def _column_rel(ms: str) -> float:
    """max|card - CPU| of the written column over the tiles of a parity
    run's observation (the card's ``ms``, the CPU's ``ms + '.cpu'``), in
    units of the data's largest magnitude (as the CPU tests gate the
    written column); of a multims run's observation, the largest over its
    parts."""
    if os.path.basename(ms) == MULTIMS_PARTS[0][0]:
        return max(_simms_column_rel(os.path.join(os.path.dirname(ms), name))
                   for name, _ in MULTIMS_PARTS)
    return _simms_column_rel(ms)


def _simms_column_rel(ms: str) -> float:
    """:func:`_column_rel` of one SimMS."""
    from sagecal_tpu_torch.io import dataset as ds
    card = ds.SimMS(ms, data_column="CORRECTED_DATA")
    cpu = ds.SimMS(ms + ".cpu", data_column="CORRECTED_DATA")
    data = ds.SimMS(ms)
    rel = 0.0
    for i in range(card.n_tiles):
        a, b = card.read_tile(i).x, cpu.read_tile(i).x
        if not np.all(np.isfinite(a)):
            raise AssertionError(f"{ms}: a written column is not finite")
        rel = max(rel, float(np.abs(a - b).max()
                             / np.abs(data.read_tile(i).x).max()))
    return rel


def _solutions_rel(obs, flags) -> float:
    """max|card - CPU| / max|CPU| of a parity run's solutions files (its
    ``@sol``)."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    ms, sky, clus = obs
    meta = ds.SimMS(ms).meta
    nchunk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                       meta["freq0"]).nchunk
    card, cpu = (np.asarray(sol.read_solutions(
        _resolve(["@sol"], path)[0], nchunk)[1]) for path in (ms, ms + ".cpu"))
    if card.shape != cpu.shape:
        raise AssertionError(f"solutions of {ms}: {card.shape} against "
                             f"{cpu.shape}")
    return float(np.abs(card - cpu).max() / np.abs(cpu).max())


def _xla_route(flags, nchunk) -> bool:
    """A run's solves take the XLA assembly: --kernel xla, or a cluster
    of more hybrid chunks than the fused sweep takes (4)."""
    return "xla" in flags or max(nchunk) > 4


def _first_flip(cuda_hist, cpu_hist):
    """The first in-flight group whose relaxation differs between the
    card and the CPU run, as (tile, group, card record, CPU record), or
    None when every decision agrees. A record is (sweep, members, omega,
    margins of the trials made)."""
    for ti, (hg, hc) in enumerate(zip(cuda_hist, cpu_hist)):
        for gi, (a, b) in enumerate(zip(hg["groups"], hc["groups"])):
            if a[2] != b[2] or a[1] != b[1]:
                return ti, gi, a, b
    return None


#: slice_parity's CPU float64 references and its card runs go to one
#: queue of this many worker processes (one a core of the card machine),
#: a run whole in one of them; the references run on this many threads
#: (5 workers of 2 threads made every job slower: the small float64
#: problems gain little from a second thread). The phase is bound by the
#: references: ~2,800 s of worker time against the card runs' ~550 s
#: (their serial sum, bound by host dispatch), on an NVIDIA H100 80GB
#: HBM3 host (700.00 W). Nothing else runs then: the e2e phases come
#: after slice_parity, alone
PARITY_WORKERS = 8
PARITY_THREADS = 1


def _parity_run(path: str, sky: str, clus: str, flags, device,
                tilesz: int = 10):
    """One slice_parity pipeline run over every tile of ``path`` (tiles
    of ``tilesz`` timeslots): (the per-tile history, seconds). ``device``
    None is the card."""
    from sagecal_tpu_torch import pipeline
    from sagecal_tpu_torch.cli import build_parser, config_from_args
    args = build_parser().parse_args(
        ["-d", path, "-s", sky, "-c", clus, "-e", "2", "-g", "10", "-l",
         "5", "-R", "0", "-t", str(tilesz)] + _resolve(flags, path))
    t0 = time.perf_counter()
    hist = pipeline.run(config_from_args(args), device=device,
                        log=lambda *a: None)
    return hist, time.perf_counter() - t0


class _Killed(RuntimeError):
    """The write failure that kills slice_parity's resume run."""


def _resume_card(path: str, sky: str, clus: str, flags, device,
                 tilesz: int = 10):
    """slice_parity's resume run on the card: killed by its residual
    write at tile 1, then ``--resume``d from the checkpoint beside its
    solutions; (the resumed run's history of tiles 1.., seconds of
    both). The sidecar must be gone at the end."""
    from sagecal_tpu_torch.io import dataset as ds
    real = ds.SimMS.write_tile

    def write(self, i, tile, column=None):
        if i == 1:
            raise _Killed("killed at tile 1")
        return real(self, i, tile, column)

    t0 = time.perf_counter()
    ds.SimMS.write_tile = write
    try:
        _parity_run(path, sky, clus, flags, device=device, tilesz=tilesz)
        raise AssertionError("slice_parity resume: the run was not killed")
    except _Killed:
        pass
    finally:
        ds.SimMS.write_tile = real
    hist, _ = _parity_run(path, sky, clus, flags + ["--resume"],
                          device=device, tilesz=tilesz)
    solpath = _resolve(["@sol"], path)[0]
    if [h["tile"] for h in hist] != list(range(1, PARITY_TILES["resume"])) \
            or os.path.exists(solpath + ".ckpt.npz"):
        raise AssertionError("slice_parity resume: the run did not resume "
                             "at tile 1 or kept its checkpoint: "
                             f"{[h['tile'] for h in hist]}")
    return hist, time.perf_counter() - t0


def make_multims(work: str, n_stations: int, tilesz: int, nchunk,
                 noise: float):
    """The multims run's two subbands (MULTIMS_PARTS, 2 channels each,
    the second with channel flags) of one 16-station observation, their
    CPU copies, and the ``-f`` lists of each side. Returns (the first
    part, sky, cluster) paths, as :func:`make_observation`."""
    paths = {"": [], ".cpu": []}
    for k, (name, chan_flags) in enumerate(MULTIMS_PARTS):
        ms, sky, clus = make_observation(
            work, n_stations, tilesz, FREQS[2 * k:2 * k + 2], len(nchunk), 6,
            nchunk, PARITY_TILES.get("multims", 2), "cpu", seed=9,
            noise=noise, chan_flags=chan_flags, name=name)
        shutil.copytree(ms, ms + ".cpu")
        for own in paths:
            paths[own].append(ms + own)
    for own, parts in paths.items():
        with open(os.path.join(work, "parts.list" + own), "w") as f:
            f.write("\n".join(parts) + "\n")
    return os.path.join(work, MULTIMS_PARTS[0][0]), sky, clus


def _parity_cpu(job):
    """A CPU reference run in a worker process: ``job`` the (path, sky,
    cluster, flags, tilesz) of :func:`_parity_run`, and with a sixth
    entry True the run computes in float32 (as the card does) where it
    would compute in float64."""
    import torch
    from sagecal_tpu_torch import device as devmod
    torch.set_num_threads(PARITY_THREADS)
    path, sky, clus, flags, tilesz = job[:5]
    if not (job[5:] and job[5]):
        return _parity_run(path, sky, clus, flags, "cpu", tilesz)
    real = devmod.real_dtype
    devmod.real_dtype = lambda dev: torch.float32
    try:
        return _parity_run(path, sky, clus, flags, "cpu", tilesz)
    finally:
        devmod.real_dtype = real


#: slice_parity's stochastic run: (stations, chunks per cluster,
#: timeslots a tile, channels, CLI flags); 2 tiles, card against CPU at
#: 1e-3 on per-tile res_0/res_1 and on the solutions, with the Armijo flip
#: rule. A minibatch holds 10 timeslots, as the full-batch runs' tiles,
#: and a band 4 of the 8 channels, as e2e_stochastic's (the kernel's
#: 8-channel instance with idle slots, the phasor recurrence). At 10
#: timeslots and 4 channels (~5 data reals a parameter a band) float32
#: alone moves J by ~3e-3 from float64, on the CPU too (ROADMAP C8,
#: tests/test_torch_stochastic_float32.py)
STOCHASTIC_PARITY = (16, (1, 2) * 4, 20, 8,
                     ["-N", "2", "-M", "2", "-w", "2"])
#: slice_parity's stochastic consensus run, on STOCHASTIC_PARITY's
#: observation: 2 ADMM iterations of one epoch, at rho 0.5. At the default
#: rho (5; the JAX package weighs the consensus term by the clusters' rho
#: summed, C12) float32 arithmetic alone moves the solutions 3.1e-3 from
#: float64 in the port (the JAX package 5.1e-3), at -N 2 -A 3 the float32
#: runs part by 4.3e-2 under a one-ulp flux move; at rho 0.5 float32 lies
#: 2.3e-4 from float64 (ROADMAP C14, tests/test_torch_stochastic_consensus
#: _float32.py).
STOCHASTIC_CONSENSUS = ["-N", "1", "-M", "2", "-w", "2", "-A", "2", "-r",
                        "0.5"]


def _stochastic_run(path: str, sky: str, clus: str, flags, device):
    """A stochastic run (stochastic consensus under -A > 1 with -w > 1,
    as the CLI routes it) over every tile of ``path`` through the CLI's
    parser, its solutions beside the SimMS: (history, seconds,
    solutions path)."""
    from sagecal_tpu_torch import stochastic
    from sagecal_tpu_torch.cli import build_parser, config_from_args
    solpath = path + ".sol"
    args = build_parser().parse_args(
        ["-d", path, "-s", sky, "-c", clus, "-l", "10", "-m", "7", "-p",
         solpath] + _resolve(flags, path))
    cfg = config_from_args(args)
    # the CLI's dispatch: -A > 1 with -w > 1 is stochastic consensus
    run = stochastic.run_minibatch_consensus \
        if cfg.n_admm > 1 and cfg.channel_avg_per_band > 1 \
        else stochastic.run_minibatch
    t0 = time.perf_counter()
    hist = run(cfg, device=device, log=lambda *a: None)
    return hist, time.perf_counter() - t0, solpath


def _stochastic_cpu(job):
    import torch
    torch.set_num_threads(PARITY_THREADS)
    return _stochastic_run(*job, device="cpu")


def _first_armijo_flip(cuda_hist, cpu_hist):
    """The first Armijo test (tile, solve, band, iteration, test) whose
    decision differs between the card and the CPU run, with both
    margins, or None when every decision agrees. A margin is (f(x + a p)
    - threshold) / |threshold|: positive halves the step."""
    for ti, (hg, hc) in enumerate(zip(cuda_hist, cpu_hist)):
        for si, (sg, sc) in enumerate(zip(hg["armijo"], hc["armijo"])):
            for b, (bg, bc) in enumerate(zip(sg, sc)):
                for it, (ig, ic) in enumerate(zip(bg, bc)):
                    for j, (mg, mc) in enumerate(zip(ig, ic)):
                        if (mg > 0) != (mc > 0):
                            return dict(tile=ti, solve=si, band=b,
                                        iteration=it, test=j,
                                        card_margin=mg, cpu_margin=mc)
    return None


def _check_stochastic_parity(tag, card, cpu, nchunk) -> dict:
    """The stochastic card run against its CPU reference: every Armijo
    decision equal (or the first flip within FLIP_MARGIN of its threshold
    on both sides, which then replaces the gates), per-tile res_0/res_1
    and the solutions within PARITY_RTOL; only the coherency kernel
    launched (under the beam, ``beam_*``, no kernel at all: the generic
    predict); under stochastic consensus every flagged band equal."""
    from sagecal_tpu_torch.io import solutions as sol
    (hg, sg, pg, launches), (hc, sc, pc) = card, cpu
    rels = [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(hg, hc)
            for k in ("res_0", "res_1")]
    Jg = np.asarray(sol.read_solutions(pg, nchunk)[1])
    Jc = np.asarray(sol.read_solutions(pc, nchunk)[1])
    j_rel = float(np.abs(Jg - Jc).max() / np.abs(Jc).max())
    flip = _first_armijo_flip(hg, hc)
    flagged = {d: [h.get("flagged_bands") for h in hist]
               for d, hist in (("cuda", hg), ("cpu", hc))}
    rec = dict(tag=tag, cuda=[[h["res_0"], h["res_1"]] for h in hg],
               cpu=[[h["res_0"], h["res_1"]] for h in hc],
               max_rel=max(rels), j_rel=j_rel, launches=launches,
               lbfgs_iters={"cuda": [h["lbfgs_iters"] for h in hg],
                            "cpu": [h["lbfgs_iters"] for h in hc]},
               halvings={d: [[[sum(m > 0 for m in it) for it in band]
                              for band in solve] for h in hist
                             for solve in h["armijo"]]
                         for d, hist in (("cuda", hg), ("cpu", hc))},
               seconds={"cuda": sg, "cpu": sc}, flip=flip,
               flagged_bands=flagged,
               duals={d: [h.get("duals") for h in hist]
                      for d, hist in (("cuda", hg), ("cpu", hc))})
    emit("slice_parity", **rec)
    if flagged["cuda"] != flagged["cpu"]:
        raise AssertionError(f"slice_parity {tag}: the bands flagged out of "
                             f"the consensus differ: {flagged}")
    beam = tag.startswith("beam")
    if bool(launches["coh"]) == beam \
            or any(launches[k] for k in SOLVE_KERNELS) \
            or launches["xla_solves"]:
        raise AssertionError(f"slice_parity {tag}: the stochastic solve must "
                             "launch the coherency kernel (none under the "
                             f"beam) and no solve kernel: {launches}")
    if flip is not None:
        if max(abs(flip["card_margin"]), abs(flip["cpu_margin"])) \
                > FLIP_MARGIN:
            raise AssertionError(f"slice_parity {tag}: an Armijo decision "
                                 f"flipped far from its threshold: {flip}")
        emit("slice_parity_flip", tag=tag, **flip,
             residual_gate="replaced by the flip report")
    elif not (max(rels) <= PARITY_RTOL and j_rel <= PARITY_RTOL):
        raise AssertionError(f"slice_parity {tag}: residuals {max(rels):.3e},"
                             f" solutions {j_rel:.3e} > {PARITY_RTOL}")
    if not all(h["res_1"] < h["res_0"] for h in hg + hc):
        raise AssertionError(f"slice_parity {tag}: residuals did not fall on "
                             "every tile")
    return rec


#: slice_parity's consensus runs (the MPI CLI, card against the CPU in
#: float64 at PARITY_RTOL): (tag, chunks per cluster, solver flags, the
#: kernels that must launch, whether the Z file is gated). 16 stations, 3
#: subbands of 2 channels whose centres lie 10 MHz apart
#: (CONSENSUS_PARITY_CENTRES), tiles of 10 timeslots (2, but 1 for
#: ``consensus_rtr_inflight``: PARITY_TILES),
#: CONSENSUS_PARITY_COMMON: ``consensus`` (LM) with the Barzilai-Borwein
#: rho from a -G file (@rho: rho 2, 3, 4 by cluster);
#: ``consensus_rtr_inflight`` RTR in groups of 2 of 8 clusters (the visits
#: kernel under ADMM). That run is RTR (-j 4), not robust RTR (-j 5): on
#: this observation float32 alone moves -j 5 in groups 2.4e-3 from
#: float64 (its robust nu grid and the groups' relaxation tests), -j 4
#: 3.7e-4 (tools_dev/torch_consensus_float32.py, on a CPU; ROADMAP C13).
#: Its Z file is recorded, not gated: RTR projects the consensus term's
#: gradient on the gauge's horizontal space, so nothing pins each
#: subband's gauge and Z carries its drift (float32 alone moves Z 4.7e-3
#: after the gauge alignment, the one-ulp run 3.6e-4; C13); its residuals
#: and written columns, which the gauge leaves alone, are gated.
#: The MPI CLI's other execution plans, each at -j 1 --inner cg (coh,
#: sweep and matvec): ``consensus_blocked`` (--block-f 2 on the 3
#: subbands: a ragged last block; one tile), ``consensus_stale``
#: (--staleness 2 with STALE_FAULTS: subband 1 skips two rounds of tile 0;
#: the schedule and the dead set equal too) and ``consensus_time_shard``
#: (--time-shard 2 over 3 tiles: shard 0 the warm chain of tiles 0 and 1,
#: shard 1 tile 2 cold-started).
CONSENSUS_PARITY = (
    ("consensus", (1, 2, 1),
     ["-j", "1", "--inner", "cg", "-C", "1", "-G", "@rho"],
     ("coh", "sweep", "matvec"), True),
    ("consensus_rtr_inflight", (1, 2, 1, 1, 2, 1, 1, 1),
     ["-j", "4", "--inner", "cg", "--inflight", "2"],
     ("coh", "visits", "matvec"), False),
    ("consensus_blocked", (1, 2, 1),
     ["-j", "1", "--inner", "cg", "--block-f", "2"],
     ("coh", "sweep", "matvec"), True),
    ("consensus_stale", (1, 2, 1),
     ["-j", "1", "--inner", "cg", "--staleness", "2", "--faults",
      json.dumps([{"point": "admm_subband_slow", "at": [1], "times": 2}])],
     ("coh", "sweep", "matvec"), True),
    ("consensus_time_shard", (1, 2, 1),
     ["-j", "1", "--inner", "cg", "--time-shard", "2"],
     ("coh", "sweep", "matvec"), True))
#: slice_parity's federated run (the MPI CLI's -N) on 2 slave subbands of
#: 16 stations, 40 timeslots and chip_smoke's 8 channels at the first two
#: CONSENSUS_PARITY_CENTRES, 8 clusters of 1 and 2 chunks (the
#: stochastic_consensus run's clusters), one tile, at -r 0.5 (ROADMAP C14):
#: per-tile residuals, slave 0's solutions and every slave's written
#: column within PARITY_RTOL, every Armijo decision and flagged band equal.
#: 40 timeslots, so 20 a minibatch: at 20 (10 a minibatch) float32 alone
#: moves the written column 8.1e-4 from float64 on the CPU and the card
#: read 8.3e-4, at 40 1.9e-4 (C8; tools_dev/torch_federated_float32.py)
FEDERATED_PARITY = (16, (1, 2) * 4, 40,
                    ["-N", "1", "-M", "2", "-w", "2", "-A", "2", "-u", "0.5",
                     "-r", "0.5", "-l", "10", "-m", "7", "-t", "40"])
CONSENSUS_PARITY_CENTRES = 150e6 + np.linspace(-10e6, 10e6, 3)
CONSENSUS_PARITY_COMMON = ["-A", "3", "-P", "2", "-e", "2", "-g", "10", "-l",
                           "5", "-R", "0", "-t", "10"]


def _consensus_obs(tag: str, nchunk, flags):
    """A consensus parity run's subbands (:func:`make_subbands`, on the
    CPU), their ``.cpu`` copies and list, the -G file: (list, sky,
    cluster, paths, flags with @rho resolved)."""
    work = os.path.join(WORK, "parity_" + tag)
    shutil.rmtree(work, ignore_errors=True)
    lst, sky, clus, paths = make_subbands(
        work, 16, 10, CONSENSUS_PARITY_CENTRES, FREQS[:2], len(nchunk), 6,
        nchunk, PARITY_TILES.get(tag, 2), "cpu", seed=9, noise=0.02)
    rho = os.path.join(work, "rho.txt")
    with open(rho, "w") as f:
        f.write("".join(f"{m} 1 {2.0 + m % 3}\n" for m in range(len(nchunk))))
    for p in paths:
        shutil.copytree(p, p + ".cpu")
    with open(lst + ".cpu", "w") as f:
        f.write("\n".join(p + ".cpu" for p in paths) + "\n")
    return lst, sky, clus, paths, [rho if f == "@rho" else f
                                   for f in CONSENSUS_PARITY_COMMON + flags]


def z_rel_aligned(Zg, Zc, P: int = 2) -> float:
    """max|Zg - Zc| / max|Zc| of two Z files' intervals ([T, M, K P, N,
    2, 2] complex, as ``io/solutions.read_solutions`` gives them) after
    turning each (interval, cluster, chunk) block of Zg, its P terms'
    2 P N x 2 stack, by the one unitary that brings it nearest Zc's
    (Procrustes: U V^H of the SVD of Zg^H Zc). The consensus problem is
    invariant under J_f -> J_f U for every subband f at once, so its Z
    is defined up to that unitary per block; the residuals are not."""
    Zg, Zc = np.asarray(Zg), np.asarray(Zc)
    out = np.empty_like(Zg)
    T, M, KP, N = Zg.shape[:4]
    for t in range(T):
        for m in range(M):
            for k in range(0, KP, P):
                a = Zg[t, m, k:k + P].reshape(-1, 2)
                b = Zc[t, m, k:k + P].reshape(-1, 2)
                w, _, vh = np.linalg.svd(a.conj().T @ b)
                out[t, m, k:k + P] = (a @ (w @ vh)).reshape(
                    Zg[t, m, k:k + P].shape)
    return float(np.abs(out - Zc).max() / np.abs(Zc).max())


def _consensus_cpu(job):
    """A consensus CPU reference in a worker process: ``job`` (list,
    sky, cluster, flags, solutions path) of :func:`_consensus_run`."""
    import torch
    torch.set_num_threads(PARITY_THREADS)
    lst, sky, clus, flags, solpath = job
    return _consensus_run(lst, sky, clus, flags, "cpu", solpath)[:2]


def _first_consensus_flip(cuda_hist, cpu_hist):
    """The first in-flight group whose relaxation differs between the
    card and the CPU consensus run, as (interval, ADMM iteration,
    subband, card record, CPU record), or None (:func:`_first_flip`'s
    rule over every subband's solve)."""
    for ti, (hg, hc) in enumerate(zip(cuda_hist, cpu_hist)):
        for it, (ig, ic) in enumerate(zip(hg["groups"], hc["groups"])):
            for f, (sg, sc) in enumerate(zip(ig, ic)):
                for a, b in zip(sg, sc):
                    if a[2] != b[2]:
                        return ti, it, f, a, b
    return None


def _check_consensus_parity(tag, obs, card, cpu, must, gate_z) -> dict:
    """A consensus card run against its CPU reference: every subband's
    res_0/res_1 on every tile, its written column (in units of the data's
    largest magnitude) and, with ``gate_z``, the Z file (each block
    turned by its gauge unitary first, :func:`z_rel_aligned`) within
    PARITY_RTOL; every divergence reset equal; the kernels of ``must``
    launched, no XLA solve; every subband's residual falling; under
    ``--staleness`` the round schedules and dead sets equal, and some
    subband skipping a round. In-flight groups' relaxation decisions are
    compared first: a flip within
    FLIP_MARGIN of its threshold replaces the gates (as slice_parity's
    group runs), a flip beyond it fails. The record carries the Z file's
    unaligned difference too."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import solutions as sol
    lst, sky, clus, paths, _ = obs
    (hg, sg, launches), (hc, sc) = card, cpu
    rels = [abs(a - b) / abs(b) for x, y in zip(hg, hc)
            for k in ("res_0_f", "res_1_f") for a, b in zip(x[k], y[k])]
    col = max(_simms_column_rel(p) for p in paths)
    nchunk = skymodel.read_sky_cluster(sky, clus, RA0, DEC0, 150e6).nchunk
    Zg, Zc = (np.asarray(sol.read_solutions(p, nchunk * 2)[1])
              for p in (lst + ".z", lst + ".cpu.z"))
    z_raw = float(np.abs(Zg - Zc).max() / np.abs(Zc).max())
    z_rel = z_rel_aligned(Zg, Zc)
    resets = {"cuda": [h["reset"] for h in hg],
              "cpu": [h["reset"] for h in hc]}
    stale = {d: [[h.get("schedule"), h.get("dead")] for h in hist]
             for d, hist in (("cuda", hg), ("cpu", hc))}
    flip = _first_consensus_flip(hg, hc)
    rec = dict(tag=tag, cuda=[[h["res_0_f"], h["res_1_f"]] for h in hg],
               cpu=[[h["res_0_f"], h["res_1_f"]] for h in hc],
               max_rel=max(rels), col_rel=col, z_rel=z_rel, z_raw=z_raw,
               resets=resets,
               duals={"cuda": [h["duals"] for h in hg],
                      "cpu": [h["duals"] for h in hc]},
               iter_s=[h["iter_s"] for h in hg], launches=launches,
               stale=stale["cuda"] if "schedule" in hg[0] else None,
               seconds={"cuda": sg, "cpu": sc}, flip=flip, z_gated=gate_z,
               omegas={d: [[[[g[2] for g in sb] for sb in it]
                             for it in h["groups"]] for h in hist]
                       for d, hist in (("cuda", hg), ("cpu", hc))})
    emit("slice_parity", **rec)
    _check_route(f"slice_parity {tag}", launches, must, False)
    if stale["cuda"] != stale["cpu"]:
        raise AssertionError(f"slice_parity {tag}: the stale schedules or "
                             f"dead sets differ: {stale}")
    if "schedule" in hg[0] and not any(0.0 in r for h in hg
                                       for r in h["schedule"]):
        raise AssertionError(f"slice_parity {tag}: no subband skipped a "
                             "round")
    if flip is not None:
        _, _, _, a, b = flip
        i = next(i for i, (ma, mb) in enumerate(zip(a[3], b[3]))
                 if (ma >= 0) != (mb >= 0))
        if max(abs(a[3][i]), abs(b[3][i])) > FLIP_MARGIN:
            raise AssertionError(f"slice_parity {tag}: relaxation decision "
                                 f"flipped far from its threshold: card {a}"
                                 f", CPU {b}")
        emit("slice_parity_flip", tag=tag, trial=i, card_margin=a[3][i],
             cpu_margin=b[3][i], residual_gate="replaced by the flip report")
        return rec
    if resets["cuda"] != resets["cpu"]:
        raise AssertionError(f"slice_parity {tag}: divergence resets differ: "
                             f"{resets}")
    if not (max(rels) <= PARITY_RTOL and col <= PARITY_RTOL
            and (z_rel <= PARITY_RTOL or not gate_z)):
        raise AssertionError(f"slice_parity {tag}: residuals {max(rels):.3e}"
                             f", column {col:.3e}, Z {z_rel:.3e} > "
                             f"{PARITY_RTOL}")
    if not all(b < a for h in hg + hc
               for a, b in zip(h["res_0_f"], h["res_1_f"])):
        raise AssertionError(f"slice_parity {tag}: a subband's residual did "
                             "not fall")
    return rec


def _federated_obs():
    """The federated parity run's slave subbands (FEDERATED_PARITY, on
    the CPU), their ``.cpu`` copies and list: (list, sky, cluster, paths,
    flags)."""
    n_st, nchunk, tsz, flags = FEDERATED_PARITY
    work = os.path.join(WORK, "parity_federated")
    shutil.rmtree(work, ignore_errors=True)
    lst, sky, clus, paths = make_subbands(
        work, n_st, tsz, CONSENSUS_PARITY_CENTRES[:2], FREQS, len(nchunk), 6,
        nchunk, 1, "cpu", seed=9, noise=0.02)
    for p in paths:
        shutil.copytree(p, p + ".cpu")
    with open(lst + ".cpu", "w") as f:
        f.write("\n".join(p + ".cpu" for p in paths) + "\n")
    return lst, sky, clus, paths, list(flags)


def consensus_parity_start(pool) -> tuple:
    """The consensus parity runs' observations (CONSENSUS_PARITY and the
    federated run), their CPU references queued on ``pool``:
    (observations, async results)."""
    cons_obs = {tag: _consensus_obs(tag, nchunk, flags)
                for tag, nchunk, flags, _, _ in CONSENSUS_PARITY}
    cons_obs["federated"] = _federated_obs()
    return cons_obs, {tag: pool.apply_async(_consensus_cpu, ((
        o[0] + ".cpu", o[1], o[2], o[4], o[0] + ".cpu.z"),))
        for tag, o in cons_obs.items()}


def consensus_parity_card_one(o) -> tuple:
    """One consensus parity run on the card, from ``o`` (of
    :func:`consensus_parity_start`): (records, seconds, launches)."""
    _reset()
    hist, secs, _ = _consensus_run(o[0], o[1], o[2], o[4], None,
                                   o[0] + ".z")
    return hist, secs, _counts()


def consensus_parity_card(cons_obs) -> dict:
    """The consensus parity runs on the card, one after another: tag ->
    (records, seconds, launches)."""
    return {tag: consensus_parity_card_one(o) for tag, o in cons_obs.items()}


def _check_federated_parity(obs, card, cpu) -> dict:
    """The federated card run against its CPU reference: the stochastic
    gates (:func:`_check_stochastic_parity`: per-tile residuals and slave
    0's solutions within PARITY_RTOL, every Armijo decision and flagged
    band equal, only the coherency kernel launched), every slave's written
    column within PARITY_RTOL, and every slave's residual falling on
    both."""
    from sagecal_tpu_torch import skymodel
    lst, sky, clus, paths, _ = obs
    (hg, sg, launches), (hc, sc) = card, cpu
    nchunk = skymodel.read_sky_cluster(sky, clus, RA0, DEC0, 150e6).nchunk
    rec = _check_stochastic_parity("federated", (hg, sg, lst + ".z",
                                                 launches),
                                   (hc, sc, lst + ".cpu.z"), nchunk)
    col = max(_simms_column_rel(p) for p in paths)
    rec.update(col_rel=col, feda={"cuda": [h["feda"] for h in hg],
                                  "cpu": [h["feda"] for h in hc]},
               slave_res={"cuda": [h["slave_res"] for h in hg],
                          "cpu": [h["slave_res"] for h in hc]})
    emit("slice_parity_federated", tag="federated", col_rel=col,
         feda=rec["feda"], slave_res=rec["slave_res"])
    if not col <= PARITY_RTOL:
        raise AssertionError(f"slice_parity federated: written column "
                             f"{col:.3e} > {PARITY_RTOL}")
    if not all(r1 < r0 for h in hg + hc for r0, r1 in h["slave_res"]):
        raise AssertionError("slice_parity federated: a slave's residual "
                             f"did not fall: {rec['slave_res']}")
    return rec


def consensus_parity_check(cons_obs, card, cpu, out: dict,
                           failures: list) -> None:
    """Every consensus parity run's record and gates
    (:func:`_check_consensus_parity`, :func:`_check_federated_parity`):
    records into ``out``, failed gates onto ``failures``."""
    for tag, _, _, must, gate_z in CONSENSUS_PARITY:
        try:
            out[tag] = _check_consensus_parity(tag, cons_obs[tag], card[tag],
                                               cpu[tag], must, gate_z)
        except AssertionError as e:
            failures.append(str(e))
    try:
        out["federated"] = _check_federated_parity(
            cons_obs["federated"], card["federated"], cpu["federated"])
    except AssertionError as e:
        failures.append(str(e))


def _parity_card_job(job) -> tuple:
    """One of slice_parity's card runs, in a card worker process
    (:func:`slice_parity_start`), its launches counted from 0: ``job``
    (kind, tag, args). ``"run"``: a PARITY_RUNS run (a spread-gated one
    SPREAD_REPS times) with its launches and route checked, args (obs,
    tilesz, flags, nchunk, must); returns (run + (launches,), reps,
    packs). ``"st"``: a stochastic run, args (obs, flags); ``"cons"``: a
    consensus run (:func:`consensus_parity_card_one`), args its
    observation; each returns its records, seconds and launches."""
    import torch
    from sagecal_tpu_torch.io import native
    # the host side of a card run on one thread, as the references: a
    # worker's default of a thread a core starves the other workers
    torch.set_num_threads(PARITY_THREADS)
    kind, tag, args = job
    _reset()
    if kind == "st":
        obs, flags = args
        return _stochastic_run(*obs, flags, device=None) + (_counts(),)
    if kind == "cons":
        return consensus_parity_card_one(args)
    obs, tilesz, flags, nchunk, must = args
    run = _resume_card if tag == "resume" else _parity_run
    packs = native.PACKS
    out = run(*obs, flags, device=None, tilesz=tilesz)
    packs = native.PACKS - packs
    launches = _counts()
    _check_route(f"slice_parity {tag}", launches, must,
                 _xla_route(flags, nchunk), _md_of(flags), _policy_of(flags))
    if tag in BEAM_RUNS and launches["coh"]:
        raise AssertionError(f"slice_parity {tag}: a beam run launched the "
                             f"coherency kernel: {launches}")
    if tag == "multims" and not packs:
        raise AssertionError("slice_parity multims: the card run did not "
                             "stage through the native tile packer")
    # the card's run-to-run spread: the same run again, after its
    # launches were read
    reps = [run(*obs, flags, device=None, tilesz=tilesz)[0]
            for _ in range(SPREAD_REPS - 1)] \
        if _spread_gated(tag, flags) else []
    return out + (launches,), reps, packs


def slice_parity_start() -> dict:
    """Start slice_parity: make every run's observation (on the CPU), and
    queue its CPU float64 references and its card runs
    (:func:`_parity_card_job`) on one pool of PARITY_WORKERS spawned
    processes, about the longest first. Returns the handle
    :func:`slice_parity_finish` takes."""
    import multiprocessing
    obs, tsz = {}, {}
    for tag, n_st, nchunk, flags, _, mixed in PARITY_RUNS:
        work = os.path.join(WORK, "parity_" + tag)
        shutil.rmtree(work, ignore_errors=True)
        tsz[tag], noise = {**REDUCED_OBS, **BEAM_OBS, **RTR_OBS}.get(
            tag, (10, 0.02))
        if tag == "multims":
            obs[tag] = make_multims(work, n_st, tsz[tag], nchunk, noise)
            continue
        ms, sky, clus = make_observation(work, n_st, tsz[tag], FREQS[:2],
                                         len(nchunk), 6, nchunk,
                                         PARITY_TILES.get(tag, 2), "cpu",
                                         seed=9, noise=noise, mixed=mixed,
                                         beam=_beam_of(flags))
        write_option_files(ms)
        shutil.copytree(ms, ms + ".cpu")
        if _spread_gated(tag, flags):
            shutil.copytree(ms, ms + ".ulp")
            perturb_sky(sky)
        if _policy_of(flags) != "f32":
            shutil.copytree(ms, ms + ".f32")
        obs[tag] = (ms, sky, clus)
    n_st, st_chunks, st_times, st_chans, st_flags = STOCHASTIC_PARITY
    st_tsz = {"stochastic": st_times, "stochastic_warm": st_times,
              "beam_stochastic": BEAM_STOCHASTIC_TIMES,
              "stochastic_consensus": st_times}
    st_runs = {"stochastic": st_flags + ["-t", str(st_times)],
               "stochastic_warm": st_flags + ["-t", str(st_times), "-q",
                                              "@warm"],
               "beam_stochastic": st_flags + ["-t",
                                              str(BEAM_STOCHASTIC_TIMES),
                                              "-B", "2"],
               "stochastic_consensus": STOCHASTIC_CONSENSUS
               + ["-t", str(st_times)]}
    st_obs = {}
    for tag in st_runs:
        work = os.path.join(WORK, "parity_" + tag)
        shutil.rmtree(work, ignore_errors=True)
        st_obs[tag] = make_observation(work, n_st, st_tsz[tag],
                                       FREQS[:st_chans], len(st_chunks), 6,
                                       st_chunks, 2, "cpu", seed=9,
                                       noise=0.02,
                                       beam=_beam_of(st_runs[tag]))
        write_option_files(st_obs[tag][0])
        shutil.copytree(st_obs[tag][0], st_obs[tag][0] + ".cpu")
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(PARITY_WORKERS)
    h = dict(pool=pool, obs=obs, tsz=tsz, st_obs=st_obs, st_runs=st_runs,
             st_chans=st_chans, t0=time.perf_counter())
    cpu_runs, ulp_runs, f32_runs, card = {}, {}, {}, {}

    def cpu_refs(runs):
        """Queue the CPU references of PARITY_RUNS ``runs``: each run's,
        a spread-gated run's under a one-ulp flux move, a reduced run's
        without its policy."""
        for tag, _, _, flags, _, _ in runs:
            ms, sky, clus = obs[tag]
            f32cpu = tag in SPREAD_F32_RUNS
            cpu_runs[tag] = pool.apply_async(
                _parity_cpu, ((ms + ".cpu", sky, clus, flags, tsz[tag],
                               f32cpu),))
            if _spread_gated(tag, flags):
                ulp_runs[tag] = pool.apply_async(
                    _parity_cpu, ((ms + ".ulp", sky + ".ulp", clus, flags,
                                   tsz[tag], f32cpu),))
            policy = _policy_of(flags)
            if policy != "f32":
                f32 = [f for f in flags if f not in ("--dtype-policy",
                                                     policy)]
                f32_runs[tag] = pool.apply_async(
                    _parity_cpu, ((ms + ".f32", sky, clus, f32, tsz[tag]),))

    def card_runs(jobs):
        """Queue card runs (:func:`_parity_card_job`), the longest first
        by stations^2 x runs."""
        for kind, tag, args, _ in sorted(jobs, key=lambda j: -j[3]):
            card[kind, tag] = pool.apply_async(_parity_card_job,
                                               ((kind, tag, args),))

    try:
        # one queue, about the longest first: the 41-station references
        # (the groups longest), the card runs, the consensus runs, the
        # rest of the references
        big = sorted((r for r in PARITY_RUNS if r[1] > 16),
                     key=lambda r: -len(r[2]))
        cpu_refs(big)
        card_runs([("run", tag, (obs[tag], tsz[tag], flags, nchunk, must),
                    n * n * (SPREAD_REPS if _spread_gated(tag, flags)
                             else 1))
                   for tag, n, nchunk, flags, must, _ in PARITY_RUNS]
                  + [("st", tag, (st_obs[tag], flags), n_st * n_st)
                     for tag, flags in st_runs.items()])
        cons_obs, cons_cpu = consensus_parity_start(pool)
        card_runs([("cons", tag, o, 0) for tag, o in cons_obs.items()])
        cpu_refs(r for r in PARITY_RUNS if r[1] <= 16)
        st_cpu = {tag: pool.apply_async(_stochastic_cpu, (
            (st_obs[tag][0] + ".cpu",) + st_obs[tag][1:] + (flags,),))
            for tag, flags in st_runs.items()}
        h.update(cons_obs=cons_obs, cons_cpu=cons_cpu, cpu_runs=cpu_runs,
                 ulp_runs=ulp_runs, f32_runs=f32_runs, st_cpu=st_cpu,
                 card=card)
    except BaseException:
        slice_parity_stop(h)
        raise
    return h


def slice_parity_stop(h: dict) -> None:
    """End slice_parity's worker processes (idempotent): terminated when
    a result is still owed, else closed; joined either way."""
    pool = h.pop("pool", None)
    if pool is not None:
        pool.terminate()
        pool.join()


def phase_slice_parity() -> dict:
    """slice_parity (:func:`slice_parity_start`,
    :func:`slice_parity_finish`), its worker processes ended however it
    ends."""
    h = slice_parity_start()
    try:
        return slice_parity_finish(h)
    finally:
        slice_parity_stop(h)


def slice_parity_finish(h: dict) -> dict:
    """Collect slice_parity's card and CPU runs (:func:`slice_parity_start`)
    and gate them: the port's pipeline on the card (kernels, float32)
    against the same pipeline on the CPU (plain versions, float64), per
    solver mode and option, and the stochastic runs (STOCHASTIC_PARITY,
    and with ``-q``). A spread-gated run (a reduced policy, or
    SPREAD_F32_RUNS) runs SPREAD_REPS times on the card, as a user's run
    does, and its gate follows both the CPU's one-ulp spread and the
    card's run-to-run spread from the order of its atomic sums (ROADMAP
    C10, C7). Every run's record first, then every failed gate at
    once."""
    obs, tsz, st_obs = h["obs"], h["tsz"], h["st_obs"]
    st_runs, st_chans, cons_obs = h["st_runs"], h["st_chans"], h["cons_obs"]
    try:
        card = {key: r.get() for key, r in h["card"].items()}
        card_s = time.perf_counter() - h["t0"]
        card_runs, reps, packs = ({tag: r[i] for (kind, tag), r
                                   in card.items() if kind == "run"}
                                  for i in range(3))
        st_card, cons_card = ({tag: r for (k, tag), r in card.items()
                               if k == kind} for kind in ("st", "cons"))
        cpu_done = {tag: r.get() for tag, r in h["cpu_runs"].items()}
        cons_cpu = {tag: r.get() for tag, r in h["cons_cpu"].items()}
        ulp_done = {tag: r.get() for tag, r in h["ulp_runs"].items()}
        f32_done = {tag: r.get()[0] for tag, r in h["f32_runs"].items()}
        st_cpu = {tag: r.get() for tag, r in h["st_cpu"].items()}
    finally:
        slice_parity_stop(h)
    # the phase's wall once its card runs and once its CPU runs were in
    emit("slice_parity_wall", card_done_s=card_s,
         all_done_s=time.perf_counter() - h["t0"],
         workers=PARITY_WORKERS)
    out = {}

    def gate(tag, n_st, nchunk, flags, mixed):
        """One run's records and gates (raises AssertionError)."""
        hist, secs = {}, {}
        hist["cuda"], secs["cuda"], launches = card_runs[tag]
        hist["cpu"], secs["cpu"] = cpu_done[tag]
        runs = [hist["cuda"]] + reps[tag]
        col_rel = _column_rel(obs[tag][0]) if tag in COLUMN_RUNS else None
        sol_rel = None
        if tag == "resume":
            # the resumed tiles against the uninterrupted run's, and the
            # whole solutions file (tile 0's from the killed run)
            hist["cpu"] = hist["cpu"][1:]
            sol_rel = _solutions_rel(obs[tag], flags)
        if "-a" in flags:
            # a simulation: no solve, the written column is the result
            rec = dict(tag=tag, stations=n_st, nchunk=nchunk, flags=flags,
                       col_rel=col_rel, launches=launches, seconds=secs,
                       tile_s={d: [h["seconds"] for h in hist[d]]
                               for d in hist})
            emit("slice_parity", **rec)
            if not col_rel <= COLUMN_RUNS[tag]:
                raise AssertionError(f"slice_parity {tag}: written column "
                                     f"{col_rel:.3e} > {COLUMN_RUNS[tag]}")
            out[tag] = rec
            return
        # -b 1: every channel's fit is held too
        chans = [(hg, hc) for a, b in zip(hist["cuda"], hist["cpu"])
                 for hg, hc in zip(a["channels"] or [],
                                   b["channels"] or [])]
        rels = [abs(hg[key] - hc[key]) / abs(hc[key])
                for hg, hc in [p for h in runs for p in zip(h, hist["cpu"])]
                + chans for key in ("res_0", "res_1")]
        # a spread-gated run's gate: the CPU run's own spread (ulp_done)
        # and the card's over its runs; a reduced policy's envelope
        # against the run without the policy (f32_done)
        gate, spread, card_spread, drift = PARITY_RTOL, None, None, None
        policy = _policy_of(flags)
        if reps[tag]:
            spread = max(abs(hu[key] - hc[key]) / abs(hc[key])
                         for hu, hc in zip(ulp_done[tag][0], hist["cpu"])
                         for key in ("res_0", "res_1"))
            card_spread = max(
                (max(h[i][key] for h in runs) - min(h[i][key] for h in runs))
                / abs(hc[key]) for i, hc in enumerate(hist["cpu"])
                for key in ("res_0", "res_1"))
            gate = min(SPREAD_CAP, max(PARITY_RTOL, SPREAD_FACTOR
                                       * max(spread, card_spread)))
        if policy != "f32":
            drift = {"cuda": [abs(h["res_1"] / hf["res_1"] - 1.0)
                              for hr in runs
                              for h, hf in zip(hr, f32_done[tag])],
                     "cpu": [abs(h["res_1"] / hf["res_1"] - 1.0)
                             for h, hf in zip(hist["cpu"], f32_done[tag])]}
        # in-flight groups: the relaxation decisions are compared first,
        # on every card run
        flip = next((f for f in (_first_flip(h, hist["cpu"]) for h in runs)
                     if f is not None), None)
        omegas = {d: [[g[2] for g in h["groups"]] for h in hist[d]]
                  for d in hist}
        rec = dict(tag=tag, stations=n_st, nchunk=nchunk, flags=flags,
                   mixed=mixed,
                   cuda=[[h["res_0"], h["res_1"], h["mean_nu"]]
                         for h in hist["cuda"]],
                   cpu=[[h["res_0"], h["res_1"], h["mean_nu"]]
                        for h in hist["cpu"]],
                   max_rel=max(rels), launches=launches, seconds=secs,
                   tile_s={d: [60.0 * h["minutes"] for h in hist[d]]
                           for d in hist},
                   solver_iters=[h["solver_iters"] for h in hist["cuda"]],
                   cg_iters=[h.get("cg_iters", 0) for h in hist["cuda"]],
                   tcg_iters=[h["tcg_iters"] for h in hist["cuda"]],
                   rejected_groups={d: [h["rejected_groups"]
                                        for h in hist[d]] for d in hist},
                   omegas=omegas, flip=flip, col_rel=col_rel,
                   sol_rel=sol_rel,
                   policy=policy, spread=spread, card_spread=card_spread,
                   gate=gate, drift_f32=drift,
                   cuda_reps=[[[h["res_0"], h["res_1"], h["mean_nu"]]
                               for h in hr] for hr in reps[tag]],
                   native_packs=packs[tag],
                   channels={d: [h["channels"] for h in hist[d]]
                             for d in hist} if chans else None)
        emit("slice_parity", **rec)
        if reps[tag] and SPREAD_FACTOR * spread > SPREAD_CAP:
            raise AssertionError(
                f"slice_parity {tag}: the CPU run moves {spread:.3e} under "
                f"one ulp, {SPREAD_FACTOR} x that > {SPREAD_CAP}: too "
                "chaotic to compare")
        if policy != "f32":
            # a reduced run: every decision equal, and the runs within
            # the envelope of the float32 one
            if flip is not None:
                raise AssertionError(f"slice_parity {tag}: a relaxation "
                                     f"decision differs: {flip}")
            if not max(drift["cuda"] + drift["cpu"]) <= ENVELOPE[policy]:
                raise AssertionError(
                    f"slice_parity {tag}: res_1 off the float32 run's by "
                    f"{drift} > {ENVELOPE[policy]}")
        if flip is not None and policy == "f32":
            # the trial where the two runs first decided differently
            _, _, a, b = flip
            i = next(i for i, (ma, mb) in enumerate(zip(a[3], b[3]))
                     if (ma >= 0) != (mb >= 0))
            if max(abs(a[3][i]), abs(b[3][i])) > FLIP_MARGIN:
                raise AssertionError(
                    f"slice_parity {tag}: relaxation decision flipped far "
                    f"from its threshold: card {a}, CPU {b}")
            emit("slice_parity_flip", tag=tag, trial=i,
                 card_margin=a[3][i], cpu_margin=b[3][i],
                 residual_gate="replaced by the flip report")
        elif not max(rels) <= gate:
            raise AssertionError(f"slice_parity {tag}: {max(rels):.3e} > "
                                 f"{gate} (spread {spread}, card "
                                 f"{card_spread})")
        elif col_rel is not None and not col_rel <= COLUMN_RUNS[tag]:
            raise AssertionError(f"slice_parity {tag}: written column "
                                 f"{col_rel:.3e} > {COLUMN_RUNS[tag]}")
        elif sol_rel is not None and not sol_rel <= PARITY_RTOL:
            raise AssertionError(f"slice_parity {tag}: solutions "
                                 f"{sol_rel:.3e} > {PARITY_RTOL}")
        if not all(h["res_1"] < h["res_0"]
                   for hr in runs + [hist["cpu"]] for h in hr) \
                or not all(hg["res_1"] < hg["res_0"]
                           and hc["res_1"] < hc["res_0"]
                           for hg, hc in chans):
            raise AssertionError(f"slice_parity {tag}: residuals did not "
                                 "fall on every tile (and channel)")
        out[tag] = rec

    # every run's record first, then every failed gate at once
    failures = []
    for tag, n_st, nchunk, flags, _, mixed in PARITY_RUNS:
        try:
            gate(tag, n_st, nchunk, flags, mixed)
        except AssertionError as e:
            failures.append(str(e))
    from sagecal_tpu_torch import skymodel
    for tag in st_runs:
        sk = skymodel.read_sky_cluster(st_obs[tag][1], st_obs[tag][2], RA0,
                                       DEC0, float(np.mean(FREQS[:st_chans])))
        try:
            out[tag] = _check_stochastic_parity(tag, st_card[tag],
                                                st_cpu[tag], sk.nchunk)
        except AssertionError as e:
            failures.append(str(e))
    consensus_parity_check(cons_obs, cons_card, cons_cpu, out, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_manifold() -> dict:
    """The phase extraction of ``-J 1`` (``consensus/manifold.
    extract_phases``: 10 x 2 Givens sweeps, each from the top eigenvector
    of a 3x3 form, ``torch.linalg.eigh`` on the tensor's device) on the
    card in float32 against the CPU in float64, for K = 4 chunks of
    N_STATIONS stations: identity J, where the form is exactly 0 and then
    diagonal, so that the result rests on the eigensolver's basis for a
    degenerate form, and random J. Gate KERNEL_RTOL on max|card - CPU|
    (the entries have modulus 1). Records the top eigenvectors the card
    and the CPU give for those degenerate forms, and the call's time."""
    import torch
    from sagecal_tpu_torch.consensus import manifold as mf
    rng = np.random.default_rng(3)
    K, N = 4, N_STATIONS
    cases = {"identity": np.tile(np.eye(2, dtype=complex), (K, N, 1, 1)),
             "random": rng.normal(size=(K, N, 2, 2))
             + 1j * rng.normal(size=(K, N, 2, 2))}
    errs, call_ms = {}, {}
    for tag, J in cases.items():
        ref = mf.extract_phases(torch.as_tensor(J)).numpy()
        Jd = torch.as_tensor(J, dtype=torch.complex64, device="cuda")
        errs[tag] = float(np.abs(mf.extract_phases(Jd).cpu().numpy()
                                 - ref).max())
        call_ms[tag] = cuda_ms(lambda: mf.extract_phases(Jd), 10)
    bases = {tag: {d: torch.linalg.eigh(torch.as_tensor(
        H, dtype=torch.float32, device=d))[1][:, -1].cpu().tolist()
        for d in ("cuda", "cpu")}
        for tag, H in (("zero", np.zeros((3, 3))),
                       ("diag_e2", np.diag([0.0, 2.0 * N, 0.0])))}
    rec = dict(K=K, N=N, max_abs_err=errs, call_ms=call_ms,
               eigh_top_vectors=bases)
    emit("manifold", **rec)
    if not max(errs.values()) <= KERNEL_RTOL:
        raise AssertionError(f"manifold: card against CPU {errs} > "
                             f"{KERNEL_RTOL}")
    return rec


def observation_e2e(tag: str = "e2e", nchunk=NCHUNK, mixed: bool = False,
                    n_tiles: int = 2, beam: int = 0):
    """A full-width synthetic observation of the e2e phases (``n_tiles``
    tiles, simulated on the card), with one cluster of N_SOURCES per
    entry of ``nchunk`` (``mixed``: every morphology, :func:`write_sky`;
    ``beam``: through that ``-B`` mode of a stored ``beam.npz``,
    :func:`make_observation`). Returns (ms, sky, cluster, setup
    seconds)."""
    work = os.path.join(WORK, tag)
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    ms, sky, clus = make_observation(work, N_STATIONS, TILESZ, FREQS,
                                     len(nchunk), N_SOURCES, nchunk, n_tiles,
                                     "cuda", seed=5, noise=0.01, mixed=mixed,
                                     beam=beam)
    return ms, sky, clus, time.perf_counter() - t0


def phase_predict_mixed():
    """The split predict at full width on a mixed sky (:func:`write_sky`
    with ``mixed``: per cluster 40 points, 16 gaussians, 4 shapelets of
    n0 = 2..6, 2 disks, 2 rings; M = 8, B = 226,920 rows, the residual's
    8 channels with per-channel flux), float32 on the card (the
    coherency kernel on the point/gaussian half, the eager envelopes on
    the rest), against the port's generic predict of the whole sky on
    the card in float64; and the rest half alone against its float64
    self. Gate max|diff|/max|ref| <= KERNEL_RTOL. Records the split's
    call ms, the rest's share of it, the coh launches (1 a call) and the
    peak device memory of a split call."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.ops import coh as coh_ops
    from sagecal_tpu_torch.rime import predict as rp
    work = os.path.join(WORK, "predict_mixed")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sky_path, clus_path = write_sky(os.path.join(work, "sky.txt"),
                                    N_CLUSTERS, N_SOURCES, NCHUNK, 21,
                                    mixed=True)
    sky = skymodel.read_sky_cluster(sky_path, clus_path, RA0, DEC0,
                                    float(np.mean(FREQS)))
    xyz = ds.random_array(N_STATIONS, seed=1)
    ha = np.linspace(0.0, ds.OMEGA_E * 10.0 * TILESZ, TILESZ, endpoint=False)
    u, v, w, _, _ = ds.uvw_tracks(xyz, DEC0, ha)
    uvw = {dt: [torch.as_tensor((a / ds.C_M_S).reshape(-1), dtype=dt,
                                device="cuda") for a in (u, v, w)]
           for dt in (torch.float32, torch.float64)}
    fdelta = 0.18e6
    split = rp.split_sky(sky, torch.float32, "cuda")
    split64 = rp.split_sky(sky, torch.float64, "cuda")
    whole64 = rp.sky_to_device(sky, torch.float64, "cuda")

    def predict():
        return rp.coherencies(split, *uvw[torch.float32], FREQS, fdelta,
                              per_channel_flux=True)

    def rest(sp, dt):
        return rp.coherencies_generic(sp.rest, *uvw[dt], FREQS, fdelta,
                                      per_channel_flux=True,
                                      with_shapelets=sp.with_shapelets)

    _reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = predict()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = coh_ops.LAUNCHES
    ref = rp.coherencies_generic(whole64, *uvw[torch.float64], FREQS, fdelta,
                                 per_channel_flux=True)
    abs_err, rel = rel_err(got.to(torch.complex128), ref)
    del ref
    rest32 = rest(split, torch.float32)
    rest_abs, rest_rel = rel_err(rest32.to(torch.complex128),
                                 rest(split64, torch.float64))
    call_ms = cuda_ms(predict, 3)
    rest_ms = cuda_ms(lambda: rest(split, torch.float32), 3)
    finite = bool(torch.isfinite(torch.view_as_real(got)).all())
    rec = dict(M=sky.n_clusters, B=int(uvw[torch.float32][0].shape[0]),
               F=len(FREQS), S=sky.max_sources,
               S_rest=int(split.rest.ll.shape[1]),
               n0max=int(round(math.sqrt(sky.sh_modes.shape[-1]))),
               stypes={int(k): int(n) for k, n in zip(*np.unique(
                   sky.stype[sky.smask], return_counts=True))},
               max_abs_err=abs_err, rel_err=rel, rest_max_abs_err=rest_abs,
               rest_rel_err=rest_rel, call_ms=call_ms, rest_ms=rest_ms,
               rest_share=rest_ms / call_ms, coh_launches=launches,
               peak_gb=peak / 2 ** 30, finite=finite)
    emit("predict_mixed", **rec)
    if launches != 1:
        raise AssertionError(f"predict_mixed: {launches} coh launches a "
                             "split call")
    if not (finite and rel <= KERNEL_RTOL and rest_rel <= KERNEL_RTOL):
        raise AssertionError(f"predict_mixed: split {rel:.3e}, rest "
                             f"{rest_rel:.3e} > {KERNEL_RTOL}")
    return rec


def _e2e_cli(obs, name: str, flags, n_tiles: int, em: int = 3):
    """One full-batch CLI run on a fresh copy of ``obs``'s SimMS at ``em``
    EM iterations (``-e``): (rc, stdout, wall s, launches, ms path,
    solutions path, peak device bytes)."""
    import contextlib
    import io
    import torch
    from sagecal_tpu_torch import cli
    src, sky, clus, _ = obs
    ms = os.path.join(os.path.dirname(src), name + ".ms")
    shutil.rmtree(ms, ignore_errors=True)
    shutil.copytree(src, ms)
    solpath = os.path.join(os.path.dirname(ms), name + "_solutions.txt")
    buf = io.StringIO()
    _reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-d", ms, "-s", sky, "-c", clus, "-p", solpath,
                       "-e", str(em), "-g", "10", "-l", "10", "-m", "7", "-t",
                       str(TILESZ), "-T", str(n_tiles), "-V"] + flags)
    torch.cuda.synchronize()
    return (rc, buf.getvalue(), time.perf_counter() - t0, _counts(), ms,
            solpath, torch.cuda.max_memory_allocated())


def phase_e2e(obs, phase: str, flags, n_tiles: int, must,
              xla: bool = False, em: int = 3):
    """The full-batch CLI at full width on the card, over the first
    ``n_tiles`` tiles of ``obs`` with solver ``flags`` at ``em`` EM
    iterations; ``must`` names the kernels that have to launch (at the
    block width of the run's ``--jones`` mode), ``xla`` a run whose
    solves must all take the XLA assembly (no sweep, matvec or visits
    launch). Under ``--jones diag|phase`` the solutions' off-diagonals
    must be exactly 0."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    _, sky, clus, setup_s = obs
    rc, out, wall, launches, ms, solpath, peak = _e2e_cli(obs, phase, flags,
                                                          n_tiles, em)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    _check_route(phase, launches, must, xla, _md_of(flags),
                 _policy_of(flags))
    tiles = []
    route = []
    for ln in out.splitlines():
        if ln.startswith("Timeslot:") and "initial=" in ln:
            tiles.append({
                "res_0": float(ln.split("initial=")[1].split(",")[0]),
                "res_1": float(ln.split("final=")[1].split(",")[0]),
                "wall_s": 60 * float(ln.split("spent=")[1].split()[0])})
        elif ln.startswith("Timeslot:") and "stats:" in ln:
            tiles[-1].update(json.loads(ln.split("stats:", 1)[1]))
        elif "solver route:" in ln:
            route.append(ln.split("solver route:", 1)[1].strip())
    ds_out = ds.SimMS(ms, data_column="CORRECTED_DATA")
    ds_in = ds.SimMS(ms)
    meta = ds_out.meta
    sk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                   meta["freq0"])
    _, blocks = sol.read_solutions(solpath, sk.nchunk)
    if _md_of(flags) < 4 and any(np.asarray(b)[..., 0, 1].any()
                                 or np.asarray(b)[..., 1, 0].any()
                                 for b in blocks):
        raise AssertionError(f"{phase}: a constrained solution has a "
                             "non-zero off-diagonal")
    ratio = []
    for i in range(n_tiles):
        xo, xi = ds_out.read_tile(i).x, ds_in.read_tile(i).x
        if not np.all(np.isfinite(xo)) or np.array_equal(xo, xi):
            raise AssertionError(f"tile {i}: output column not written")
        ratio.append(float(np.abs(xo).mean() / np.abs(xi).mean()))
    rec = dict(flags=flags, em=em, tiles=tiles, wall_s=wall, setup_s=setup_s,
               launches=launches, route=route, intervals=len(blocks),
               written_over_data=ratio, kmax=int(max(sk.nchunk)),
               peak_gb=peak / 2 ** 30,
               B=TILESZ * N_STATIONS * (N_STATIONS - 1) // 2,
               F=len(FREQS), M=sk.n_clusters, S=sk.max_sources,
               stypes={int(k): int(v) for k, v in zip(*np.unique(
                   sk.stype[sk.smask], return_counts=True))})
    emit(phase, **rec)
    if len(blocks) != n_tiles:
        raise AssertionError(f"solutions file holds {len(blocks)} intervals")
    if len(tiles) != n_tiles or not all(
            math.isfinite(h["res_1"]) and math.isfinite(h["res_0"])
            and h["res_1"] < h["res_0"] for h in tiles):
        raise AssertionError(f"{phase}: residuals did not fall: {tiles}")
    return rec


def phase_e2e_reduced(obs, phase: str, flags, policy: str, must,
                      f32: dict) -> dict:
    """The first tile of ``obs`` at ``--dtype-policy policy`` with solver
    ``flags`` at ``-e 1`` (:func:`phase_e2e`: the run must launch the
    kernels of ``must`` and its sweep and visits instances at ``policy``
    only), its final residual within ENVELOPE[policy] of tile 0 of
    ``f32``, the same flags' float32 run on the same observation."""
    rec = phase_e2e(obs, phase, flags + ["--dtype-policy", policy], 1, must,
                    em=1)
    r32 = f32["tiles"][0]["res_1"]
    drift = abs(rec["tiles"][0]["res_1"] / r32 - 1.0)
    emit(phase + "_envelope", policy=policy, res_1=rec["tiles"][0]["res_1"],
         res_1_f32=r32, drift=drift, envelope=ENVELOPE[policy],
         by_st=rec["launches"]["by_st"])
    if not rec["launches"]["by_st"] or not drift <= ENVELOPE[policy]:
        raise AssertionError(f"{phase}: no sweep instance launched, or "
                             f"res_1 {drift:.3e} from the float32 run's "
                             f"(envelope {ENVELOPE[policy]})")
    return rec


def phase_e2e_bandpass(obs) -> dict:
    """``-j 1 -b 1 -e 1`` at full width on the first tile of ``obs``: the
    joint SAGE solve without its refine, then one LBFGS fit a channel
    from the joint solution (``-l 10``), the channels' residuals written.
    Every channel's fit must lower its cost, and the coherency kernel
    launch exactly twice: once at F = 1 (the joint solve) and once at F
    = 8 (all channels' solves and residuals)."""
    rec = phase_e2e(obs, "e2e_bandpass", ["-j", "1", "-b", "1"], 1,
                    ("coh", "sweep"), em=1)
    chans = rec["tiles"][0]["channels"]
    if len(chans) != len(FREQS) or not all(
            c["res_1"] < c["res_0"] for c in chans):
        raise AssertionError(f"e2e_bandpass: a channel's fit did not lower "
                             f"its cost: {chans}")
    if rec["launches"]["coh_by_f"] != {"F1": 1, "F8": 1}:
        raise AssertionError("e2e_bandpass: the coherency kernel must launch "
                             "once at F = 1 and once at F = 8: "
                             f"{rec['launches']}")
    return rec


def one_tile_copy(src: str, dst: str) -> str:
    """A SimMS of ``src``'s first tile alone at ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    meta["n_tiles"] = 1
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    shutil.copy(os.path.join(src, "tile00000.npz"), dst)
    return dst


#: e2e_sim: the cluster its -z list names
SIM_IGNORE = 3


def phase_e2e_sim(obs, solpath: str) -> dict:
    """The simulation modes through the CLI at full width on the first
    tile of ``obs``: ``-a 1``, ``-a 2`` and ``-a 3`` with ``-p`` (e2e_rtr's
    solutions, ``solpath``) and ``-z`` naming SIM_IGNORE, and ``-a 1 -p``
    without ``-z``. On the card's outputs, a2 - data, data - a3 and a1
    must agree within 1e-5 of max|a1|, and (a1 without -z) - a1 must be
    the ignored cluster's corrupted model, predicted here on the card,
    within 1e-5 of max|a1 without -z|. Records each run's wall and coh
    launches, and CUDA-event times of one tile's simulate call (-a 2 with
    J and -z) and of its coherency call alone."""
    import contextlib
    import io
    import torch
    from sagecal_tpu_torch import cli, skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    from sagecal_tpu_torch.rime import predict as rp
    from sagecal_tpu_torch.rime import residual as rr
    src, sky, clus, _ = obs
    work = os.path.dirname(src)
    one = one_tile_copy(src, os.path.join(work, "sim_tile0.ms"))
    ign = os.path.join(work, "sim_ignore.txt")
    with open(ign, "w") as f:
        f.write(f"{SIM_IGNORE}\n")
    runs = {f"a{m}": ["-a", str(m), "-p", solpath, "-z", ign]
            for m in (1, 2, 3)}
    runs["a1_all"] = ["-a", "1", "-p", solpath]
    col, walls, launches = {}, {}, {}
    for tag, flags in runs.items():
        ms = os.path.join(work, f"sim_{tag}.ms")
        shutil.rmtree(ms, ignore_errors=True)
        shutil.copytree(one, ms)
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-d", ms, "-s", sky, "-c", clus] + flags)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        launches[tag] = _counts()
        if rc != 0:
            raise AssertionError(f"e2e_sim {tag}: cli.main returned {rc}")
        col[tag] = ds.SimMS(ms, data_column="CORRECTED_DATA").read_tile(0).x
        shutil.rmtree(ms, ignore_errors=True)
    tile = ds.SimMS(one).read_tile(0)
    x = tile.x
    a1 = col["a1"]
    scale = float(np.abs(a1).max())
    meta = ds.SimMS(one).meta
    sk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                   meta["freq0"])
    dsky = rp.split_sky(sk, torch.float32, "cuda")
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device="cuda",
                                                    dtype=dt)
    u, v, w = t(tile.u), t(tile.v), t(tile.w)
    s1, s2 = t(tile.sta1, torch.long), t(tile.sta2, torch.long)
    cidx = t(rp.chunk_indices(meta["tilesz"], meta["nbase"], sk.nchunk),
             torch.long)
    J = t(sol.read_solutions(solpath, sk.nchunk)[1][0], torch.complex64)
    fdc = meta["fdelta"] / len(meta["freqs"])
    only = sk.cluster_ids == SIM_IGNORE
    alone = rr.simulate_visibilities(
        dsky, None, u, v, w, meta["freqs"], fdc, s1, s2, mode=1, J=J,
        chunk_idx=cidx, ignore_mask=only).cpu().numpy()
    errs = dict(
        add=float(np.abs(col["a2"] - x - a1).max()) / scale,
        subtract=float(np.abs(x - col["a3"] - a1).max()) / scale,
        ignored=float(np.abs(col["a1_all"] - a1 - alone).max()
                      / np.abs(col["a1_all"]).max()))
    xd = t(x, torch.complex64)
    keep = ~only
    sim_ms = cuda_ms(lambda: rr.simulate_visibilities(
        dsky, xd, u, v, w, meta["freqs"], fdc, s1, s2, mode=2, J=J,
        chunk_idx=cidx, ignore_mask=keep), 5)
    coh_ms = cuda_ms(lambda: rp.coherencies(
        dsky, u, v, w, meta["freqs"], fdc, per_channel_flux=True), 5)
    rec = dict(runs=runs, wall_s=walls, launches=launches, errs=errs,
               coh_launches=sum(n["coh"] for n in launches.values()),
               sim_call_ms=sim_ms, coh_call_ms=coh_ms,
               beyond_coh_ms=sim_ms - coh_ms, B=len(tile.u), F=len(FREQS),
               M=sk.n_clusters, ignored=SIM_IGNORE)
    emit("e2e_sim", **rec)
    if not max(errs.values()) <= 1e-5 or not np.all(np.isfinite(a1)):
        raise AssertionError(f"e2e_sim: the modes do not compose: {errs}")
    if any(n["coh"] != 1 or any(n[k] for k in SOLVE_KERNELS)
           for n in launches.values()):
        raise AssertionError("e2e_sim: a run must launch the coherency "
                             f"kernel once and no solve kernel: {launches}")
    shutil.rmtree(one, ignore_errors=True)
    return rec


#: e2e_stochastic: -N 2 epochs of -M 4 minibatches (30 timeslots) over -w 2
#: bands of 4 channels, on 2 tiles of e2e_rtr's observation
E2E_STOCHASTIC = ["-N", "2", "-M", "4", "-w", "2"]


def phase_e2e_stochastic(obs) -> dict:
    """Stochastic calibration through the CLI at full width on the first
    2 tiles of ``obs`` (E2E_STOCHASTIC, robust LBFGS at -l 10 -m 7): per
    tile its seconds, res_0, res_1, LBFGS iterations, line searches that
    took their last step untested, and coh launches.
    Every tile's residual must fall and be finite, the coherency kernel
    launch, and no sweep, matvec or visits kernel nor XLA solve run; the
    written column is finite and changed, the solutions file holds 2
    intervals of 2 bands. The record carries the written column's mean
    magnitude over the data's a tile (``written_over_data``)."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    _, sky, clus, setup_s = obs
    rc, out, wall, launches, ms, solpath, peak = _e2e_cli(
        obs, "e2e_stochastic", E2E_STOCHASTIC, 2)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    tiles = []
    for ln in out.splitlines():
        if ln.startswith("Timeslot:") and "initial=" in ln:
            tiles.append({
                "res_0": float(ln.split("initial=")[1].split(",")[0]),
                "res_1": float(ln.split("final=")[1].split(",")[0]),
                "wall_s": 60 * float(ln.split("spent=")[1].split()[0])})
        elif ln.startswith("Timeslot:") and "stats:" in ln:
            tiles[-1].update(json.loads(ln.split("stats:", 1)[1]))
    ds_out = ds.SimMS(ms, data_column="CORRECTED_DATA")
    ds_in = ds.SimMS(ms)
    meta = ds_out.meta
    sk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                   meta["freq0"])
    header, blocks = sol.read_solutions(solpath, sk.nchunk)
    ratio = []
    for i in range(2):
        xo, xi = ds_out.read_tile(i).x, ds_in.read_tile(i).x
        if not np.all(np.isfinite(xo)) or np.array_equal(xo, xi):
            raise AssertionError(f"e2e_stochastic tile {i}: output column "
                                 "not written")
        ratio.append(float(np.abs(xo).mean() / np.abs(xi).mean()))
    rec = dict(flags=E2E_STOCHASTIC, tiles=[
        dict(wall_s=t["wall_s"], res_0=t["res_0"], res_1=t["res_1"],
             lbfgs_iters=t.get("lbfgs_iters"),
             lbfgs_exhausted=t.get("lbfgs_exhausted"),
             coh_launches=t.get("launches", {}).get("coh"))
        for t in tiles], wall_s=wall, setup_s=setup_s, launches=launches,
        intervals=len(blocks), nsolbw=header.get("nsolbw"),
        written_over_data=ratio, peak_gb=peak / 2 ** 30,
        B=(TILESZ // 4) * N_STATIONS * (N_STATIONS - 1) // 2, F=4,
        M=sk.n_clusters, S=sk.max_sources)
    emit("e2e_stochastic", **rec)
    if launches["coh"] == 0 or any(launches[k] for k in SOLVE_KERNELS) \
            or launches["xla_solves"]:
        raise AssertionError("e2e_stochastic: the run must launch the "
                             "coherency kernel and no solve kernel: "
                             f"{launches}")
    if len(blocks) != 2 or header.get("nsolbw") != 2:
        raise AssertionError(f"e2e_stochastic: solutions {len(blocks)} "
                             f"intervals, header {header}")
    if len(tiles) != 2 or not all(
            math.isfinite(h["res_1"]) and math.isfinite(h["res_0"])
            and h["res_1"] < h["res_0"] for h in tiles):
        raise AssertionError(f"e2e_stochastic: residuals did not fall: "
                             f"{tiles}")
    return rec


#: consensus calibration (the MPI CLI): 4 subbands of the full-width
#: observation, each chip_smoke's 8 channels moved to its centre, the
#: centres spread over 40 MHz
CONSENSUS_CENTRES = 150e6 + np.linspace(-20e6, 20e6, 4)
E2E_CONSENSUS = ["-A", "3", "-P", "2", "-j", "1", "--inner", "cg", "-e", "1"]


def make_subbands(work: str, n_stations: int, tilesz: int, centres, chans,
                  n_clusters: int, n_sources: int, nchunk, n_tiles: int,
                  device, seed: int = 5, noise: float = 0.01):
    """Sky files and one SimMS a subband (``sbNN.ms``, ``n_tiles`` tiles)
    of one array: the channels ``chans`` moved to each of ``centres``,
    corrupted by gains smooth in frequency, J_f = J0 + slope (f - f0) /
    f0 at the subband's centre f (f0 the centres' mean; the rule of
    ``tests/test_cli_mpi.py``'s subbands), simulated on ``device``.
    Returns (the ``-f`` list file, sky, cluster, the SimMS paths)."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.rime import predict as rp
    os.makedirs(work, exist_ok=True)
    sky_path, clus_path = write_sky(os.path.join(work, "sky.txt"),
                                    n_clusters, n_sources, nchunk, seed)
    f0 = float(np.mean(centres))
    sky = skymodel.read_sky_cluster(sky_path, clus_path, RA0, DEC0, f0)
    rdt = torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
    dsky = rp.split_sky(sky, rdt, device)
    J0 = ds.random_jones(sky.n_clusters, sky.nchunk, n_stations, seed=seed,
                         scale=0.2)
    slope = ds.random_jones(sky.n_clusters, sky.nchunk, n_stations,
                            seed=seed + 1, scale=0.05) - np.eye(2)
    offs = np.asarray(chans, np.float64) - np.mean(chans)
    paths = []
    for f, fc in enumerate(centres):
        J = J0 + slope * (fc - f0) / f0
        tiles = [ds.simulate_dataset(dsky, n_stations, tilesz, fc + offs,
                                     RA0, DEC0, jones=J, nchunk=sky.nchunk,
                                     noise_sigma=noise, seed=seed + 10 * i)
                 for i in range(n_tiles)]
        paths.append(os.path.join(work, f"sb{f:02d}.ms"))
        ds.SimMS.create(paths[-1], tiles)
    lst = os.path.join(work, "subbands.list")
    with open(lst, "w") as fh:
        fh.write("\n".join(paths) + "\n")
    return lst, sky_path, clus_path, paths


def _consensus_run(lst: str, sky: str, clus: str, flags, device,
                   solpath: str, extra=()):
    """One MPI CLI run (``cli_mpi.run``) over every interval of the
    subbands in ``lst``: (records, seconds, log lines). ``device`` None
    is the card."""
    from sagecal_tpu_torch import cli_mpi
    lines = []
    argv = ["-f", lst, "-s", sky, "-c", clus, "-p", solpath, "-V"] \
        + list(flags) + list(extra) \
        + (["--platform", "cpu"] if device == "cpu" else [])
    t0 = time.perf_counter()
    hist = cli_mpi.run(argv, log=lines.append)
    return hist, time.perf_counter() - t0, lines


def phase_e2e_consensus() -> dict:
    """The MPI CLI (consensus ADMM over subbands) at full width on the
    card: 4 subbands (CONSENSUS_CENTRES) of one full-width tile each
    (N_STATIONS, TILESZ, 8 channels, N_CLUSTERS of N_SOURCES with NCHUNK)
    at E2E_CONSENSUS. The run must launch coh, sweep and matvec, and take
    no XLA solve; every subband's residual must fall; the written columns
    are finite and changed, the Z file holds one interval of Mt x 2
    columns and every worker file one interval. Records the wall of each
    ADMM iteration and of the interval, the dual residual per iteration,
    res_1 / res_0 per subband, the launches and the peak device
    memory."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    work = os.path.join(WORK, "e2e_consensus")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    lst, sky, clus, paths = make_subbands(
        work, N_STATIONS, TILESZ, CONSENSUS_CENTRES, FREQS, N_CLUSTERS,
        N_SOURCES, NCHUNK, 1, "cuda")
    setup_s = time.perf_counter() - t0
    solpath = os.path.join(work, "zsol.txt")
    _reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, wall, _ = _consensus_run(
        lst, sky, clus, E2E_CONSENSUS + ["-g", "10", "-t", str(TILESZ)],
        None, solpath)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    _check_route("e2e_consensus", launches, ("coh", "sweep", "matvec"),
                 False)
    sk = skymodel.read_sky_cluster(sky, clus, RA0, DEC0,
                                   float(np.mean(CONSENSUS_CENTRES)))
    header, blocks = sol.read_solutions(solpath, sk.nchunk * 2)
    workers = [len(sol.read_solutions(p + ".solutions", sk.nchunk)[1])
               for p in paths]
    ratio = []
    for p in paths:
        xo = ds.SimMS(p, data_column="CORRECTED_DATA").read_tile(0).x
        xi = ds.SimMS(p).read_tile(0).x
        if not np.all(np.isfinite(xo)) or np.array_equal(xo, xi):
            raise AssertionError(f"e2e_consensus {p}: output column not "
                                 "written")
        ratio.append(float(np.abs(xo).mean() / np.abs(xi).mean()))
    h = hist[0]
    rec = dict(flags=E2E_CONSENSUS, subbands=len(paths),
               centres_mhz=[c / 1e6 for c in CONSENSUS_CENTRES],
               wall_s=wall, setup_s=setup_s, iter_s=h["iter_s"],
               interval_s=h["interval_s"], residual_s=h["residual_s"],
               duals=h["duals"], res_0=h["res_0_f"], res_1=h["res_1_f"],
               res_ratio=[b / a for a, b in zip(h["res_0_f"], h["res_1_f"])],
               r1s=h["r1s"], reset=h["reset"], launches=launches,
               peak_gb=peak / 2 ** 30, written_over_data=ratio,
               z_intervals=len(blocks),
               z_columns=header.get("n_eff_clusters"),
               worker_intervals=workers,
               B=TILESZ * N_STATIONS * (N_STATIONS - 1) // 2, F=len(FREQS),
               M=sk.n_clusters, S=sk.max_sources)
    emit("e2e_consensus", **rec)
    if not all(math.isfinite(a) and math.isfinite(b) and b < a
               for a, b in zip(h["res_0_f"], h["res_1_f"])):
        raise AssertionError(f"e2e_consensus: a subband's residual did not "
                             f"fall: {h['res_0_f']} -> {h['res_1_f']}")
    if len(blocks) != 1 or header.get("n_eff_clusters") \
            != 2 * sk.n_eff_clusters or workers != [1] * len(paths):
        raise AssertionError(f"e2e_consensus: Z file {len(blocks)} "
                             f"intervals, header {header}, workers {workers}")
    if launches["visits"]:
        raise AssertionError("e2e_consensus: a sequential run launched the "
                             f"visits kernel: {launches}")
    shutil.rmtree(work, ignore_errors=True)
    return rec


#: federated stochastic calibration (the MPI CLI's -N): 2 slave subbands
#: of the full-width observation at the middle two CONSENSUS_CENTRES
E2E_FEDERATED = ["-N", "1", "-M", "2", "-w", "2", "-A", "2", "-u", "0.5"]


def phase_e2e_federated() -> dict:
    """Federated stochastic calibration through the MPI CLI at full
    width on the card: 2 slave subbands (N_STATIONS, TILESZ, chip_smoke's
    8 channels at CONSENSUS_CENTRES[1:3], N_CLUSTERS of N_SOURCES with
    NCHUNK; one tile each) at E2E_FEDERATED. The run must launch the
    coherency kernel and no sweep, matvec or visits kernel nor XLA solve;
    every slave's residual must fall (its first solve's res_0 against its
    last solve's res_1), the written columns be finite and changed, and
    slave 0's solutions file hold one interval of 2 bands. Records the
    tile wall and its split (each outer iteration's seconds, the end of
    the tile: residuals and solutions), the FEDA dual residual per outer
    iteration, res_1 / res_0 per slave, the LBFGS iterations, the
    launches and the peak device memory."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    work = os.path.join(WORK, "e2e_federated")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    lst, sky, clus, paths = make_subbands(
        work, N_STATIONS, TILESZ, CONSENSUS_CENTRES[1:3], FREQS, N_CLUSTERS,
        N_SOURCES, NCHUNK, 1, "cuda")
    setup_s = time.perf_counter() - t0
    solpath = os.path.join(work, "sol.txt")
    _reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist, wall, _ = _consensus_run(
        lst, sky, clus, E2E_FEDERATED + ["-t", str(TILESZ)], None, solpath)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = _counts()
    sk = skymodel.read_sky_cluster(sky, clus, RA0, DEC0,
                                   float(np.mean(CONSENSUS_CENTRES[1:3])))
    header, blocks = sol.read_solutions(solpath, sk.nchunk)
    ratio = []
    for p in paths:
        xo = ds.SimMS(p, data_column="CORRECTED_DATA").read_tile(0).x
        xi = ds.SimMS(p).read_tile(0).x
        if not np.all(np.isfinite(xo)) or np.array_equal(xo, xi):
            raise AssertionError(f"e2e_federated {p}: output column not "
                                 "written")
        ratio.append(float(np.abs(xo).mean() / np.abs(xi).mean()))
    h = hist[0]
    rec = dict(flags=E2E_FEDERATED, slaves=len(paths),
               centres_mhz=[c / 1e6 for c in CONSENSUS_CENTRES[1:3]],
               wall_s=wall, setup_s=setup_s, tile_s=60.0 * h["minutes"],
               outer_s=h["outer_s"], tail_s=h["tail_s"], feda=h["feda"],
               res_0=h["res_0"], res_1=h["res_1"], slave_res=h["slave_res"],
               res_ratio=[r1 / r0 for r0, r1 in h["slave_res"]],
               lbfgs_iters=h["lbfgs_iters"], launches=launches,
               peak_gb=peak / 2 ** 30, written_over_data=ratio,
               intervals=len(blocks), nsolbw=header.get("nsolbw"),
               B=(TILESZ // 2) * N_STATIONS * (N_STATIONS - 1) // 2, F=4,
               M=sk.n_clusters, S=sk.max_sources)
    emit("e2e_federated", **rec)
    if launches["coh"] == 0 or any(launches[k] for k in SOLVE_KERNELS) \
            or launches["xla_solves"]:
        raise AssertionError("e2e_federated: the run must launch the "
                             "coherency kernel and no solve kernel: "
                             f"{launches}")
    if not all(math.isfinite(r0) and math.isfinite(r1) and r1 < r0
               for r0, r1 in h["slave_res"]):
        raise AssertionError(f"e2e_federated: a slave's residual did not "
                             f"fall: {h['slave_res']}")
    if len(blocks) != 1 or header.get("nsolbw") != 2:
        raise AssertionError(f"e2e_federated: solutions {len(blocks)} "
                             f"intervals, header {header}")
    if len(h["feda"]) != 2:
        raise AssertionError(f"e2e_federated: one FEDA residual an outer "
                             f"iteration expected: {h['feda']}")
    shutil.rmtree(work, ignore_errors=True)
    return rec


#: e2e_stochastic_consensus: e2e_stochastic's run at -A 3 on one tile
E2E_STOCHASTIC_CONSENSUS = E2E_STOCHASTIC + ["-A", "3"]


def phase_e2e_stochastic_consensus(obs) -> dict:
    """Stochastic consensus through the full-batch CLI (``-N 2 -M 4 -w 2
    -A 3``: the bands tied by ADMM to the frequency polynomial) at full
    width on the first tile of ``obs``: its seconds, res_0 and res_1, the
    dual residual and the flagged bands per solve, LBFGS iterations and
    launches. The residual must fall, the coherency kernel launch and no
    solve kernel nor XLA solve run; the written column is finite and
    changed, the solutions file one interval of 2 bands."""
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.io import solutions as sol
    _, sky, clus, setup_s = obs
    rc, out, wall, launches, ms, solpath, peak = _e2e_cli(
        obs, "e2e_stochastic_consensus", E2E_STOCHASTIC_CONSENSUS, 1)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    tiles = []
    for ln in out.splitlines():
        if ln.startswith("Timeslot:") and "initial=" in ln:
            tiles.append({
                "res_0": float(ln.split("initial=")[1].split(",")[0]),
                "res_1": float(ln.split("final=")[1].split(",")[0]),
                "wall_s": 60 * float(ln.split("spent=")[1].split()[0])})
        elif ln.startswith("Timeslot:") and "stats:" in ln:
            tiles[-1].update(json.loads(ln.split("stats:", 1)[1]))
    meta = ds.SimMS(ms).meta
    sk = skymodel.read_sky_cluster(sky, clus, meta["ra0"], meta["dec0"],
                                   meta["freq0"])
    header, blocks = sol.read_solutions(solpath, sk.nchunk)
    xo = ds.SimMS(ms, data_column="CORRECTED_DATA").read_tile(0).x
    xi = ds.SimMS(ms).read_tile(0).x
    if not np.all(np.isfinite(xo)) or np.array_equal(xo, xi):
        raise AssertionError("e2e_stochastic_consensus: output column not "
                             "written")
    rec = dict(flags=E2E_STOCHASTIC_CONSENSUS, tiles=tiles, wall_s=wall,
               setup_s=setup_s, launches=launches, intervals=len(blocks),
               nsolbw=header.get("nsolbw"),
               written_over_data=float(np.abs(xo).mean()
                                       / np.abs(xi).mean()),
               peak_gb=peak / 2 ** 30,
               B=(TILESZ // 4) * N_STATIONS * (N_STATIONS - 1) // 2, F=4,
               M=sk.n_clusters)
    emit("e2e_stochastic_consensus", **rec)
    if launches["coh"] == 0 or any(launches[k] for k in SOLVE_KERNELS) \
            or launches["xla_solves"]:
        raise AssertionError("e2e_stochastic_consensus: the run must launch "
                             "the coherency kernel and no solve kernel: "
                             f"{launches}")
    if len(blocks) != 1 or header.get("nsolbw") != 2:
        raise AssertionError(f"e2e_stochastic_consensus: solutions "
                             f"{len(blocks)} intervals, header {header}")
    if len(tiles) != 1 or not (math.isfinite(tiles[0]["res_1"])
                               and tiles[0]["res_1"] < tiles[0]["res_0"]):
        raise AssertionError("e2e_stochastic_consensus: the residual did "
                             f"not fall: {tiles}")
    if len(tiles[0].get("duals", [])) != 3 * 2 * 4:
        raise AssertionError("e2e_stochastic_consensus: one dual a solve "
                             f"expected: {tiles[0].get('duals')}")
    return rec


def phase_e2e_beam(rtr: dict) -> dict:
    """``-j 5 --inner cg -B 2 -e 1`` at full width on a one-tile
    observation of e2e_rtr's sky and gains, simulated on the card through
    the full beam (``-B 2``) of its stored ``beam.npz`` (a
    ``synthetic_beam`` of N_STATIONS stations over the tile's times;
    :func:`make_observation`): the sky precessed, every predict through
    the generic route with the beam tables. The run must launch the sweep
    and matvec kernels and no coherency kernel, and lower the residual.
    Then the beam predict alone on the tile, as the run makes it (the
    solve's, F = 1, and the residual's, F = 8): its seconds
    (synchronized, median of 3) and peak device memory above what was
    allocated before it. Emits them beside e2e_rtr's tile 0 (``rtr``,
    the same call)."""
    obs = observation_e2e("e2e_beam", n_tiles=1, beam=2)
    try:
        return _e2e_beam_on(obs, rtr)
    finally:
        shutil.rmtree(os.path.dirname(obs[0]), ignore_errors=True)


def _e2e_beam_on(obs, rtr: dict) -> dict:
    """:func:`phase_e2e_beam` on its observation ``obs``."""
    import torch
    from sagecal_tpu_torch import skymodel
    from sagecal_tpu_torch.io import dataset as ds
    from sagecal_tpu_torch.rime import beam as bm
    from sagecal_tpu_torch.rime import predict as rp
    src = ds.SimMS(obs[0])
    tile = src.read_tile(0)
    meta = src.meta
    info = src.beam_info()
    rec = phase_e2e(obs, "e2e_beam", ["-j", "5", "--inner", "cg", "-B",
                                      "2"], 1, ("sweep", "matvec"), em=1)
    if rec["launches"]["coh"]:
        raise AssertionError("e2e_beam: a beam run launched the coherency "
                             f"kernel: {rec['launches']}")
    dev = torch.device("cuda")
    sky = skymodel.read_sky_cluster(obs[1], obs[2], meta["ra0"],
                                    meta["dec0"], meta["freq0"])
    dsky = rp.sky_to_device(sky, torch.float32, dev)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev, dtype=dt)
    kw = dict(beam=bm.beam_to_device(info, meta["freq0"], torch.float32,
                                     time_jd=tile.time_jd, device=dev),
              dobeam=2, tslot=t(tile.tslot, torch.long),
              sta1=t(tile.sta1, torch.long), sta2=t(tile.sta2, torch.long))
    uvw = [t(tile.u), t(tile.v), t(tile.w)]
    out = {}
    for tag, fl, fd, pcf in (
            ("solve_F1", [meta["freq0"]], meta["fdelta"], False),
            ("residual_F8", meta["freqs"], meta["fdelta"] / len(FREQS),
             True)):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            coh = rp.coherencies(dsky, *uvw, fl, fd, per_channel_flux=pcf,
                                 **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() - base
            finite = bool(torch.isfinite(torch.view_as_real(coh)).all())
            del coh
        out[tag] = dict(s=float(np.median(secs)), peak_gb=peak / 2 ** 30,
                        finite=finite)
    tile0 = rec["tiles"][0]
    emit("e2e_beam_summary", wall_s=tile0["wall_s"],
         em_s=tile0.get("em_s"), refine_s=tile0.get("refine_s"),
         residual_s=tile0.get("residual_s"), predict=out,
         predict_share=(out["solve_F1"]["s"] + out["residual_F8"]["s"])
         / tile0["wall_s"], peak_gb_run=rec["peak_gb"],
         setup_s=obs[3], res_ratio=tile0["res_1"] / tile0["res_0"],
         tcg_iters=tile0.get("tcg_iters"),
         e2e_rtr_tile0_s=rtr["tiles"][0]["wall_s"],
         e2e_rtr_tile0_res_ratio=rtr["tiles"][0]["res_1"]
         / rtr["tiles"][0]["res_0"],
         e2e_rtr_tile0_tcg_iters=rtr["tiles"][0].get("tcg_iters"),
         launches=rec["launches"])
    if not all(o["finite"] for o in out.values()):
        raise AssertionError(f"e2e_beam: a beam predict is not finite: {out}")
    rec["predict"] = out
    return rec


def phase_e2e_tile_batch(rtr: dict) -> dict:
    """``-j 5 --inner cg --tile-batch TILE_BATCH`` at full width on 1 +
    TILE_BATCH tiles of e2e_rtr's observation: tile 0 alone (the boost;
    the single-visit sweep and the matvec), tiles 1.. one batch (the
    visits kernel at one visit a tile and the matvec at TILE_BATCH kmax
    chunks, no single-visit sweep), at e2e_rtr's ``-e 1``. Emits the
    batch's EM, refine and solve seconds, seconds a tile and launches
    beside e2e_rtr's warm tile 1 (``rtr``, the same run)."""
    n = 1 + TILE_BATCH
    obs = observation_e2e("e2e_tile_batch", n_tiles=n)
    rec = phase_e2e(obs, "e2e_tile_batch",
                    ["-j", "5", "--inner", "cg", "--tile-batch",
                     str(TILE_BATCH)], n, ("coh", "sweep", "visits",
                                           "matvec"), em=1)
    shutil.rmtree(os.path.dirname(obs[0]), ignore_errors=True)
    solo, first, rest = rec["tiles"][0], rec["tiles"][1], rec["tiles"][2:]
    batch = first["batch"]
    if solo["batch"] is not None or any(
            t["batch"] != batch for t in rest) \
            or batch["tiles"] != list(range(1, n)):
        raise AssertionError(f"e2e_tile_batch: tiles 1..{n - 1} did not "
                             f"solve as one batch: {rec['tiles']}")
    solve = ("sweep", "visits", "matvec")
    if solo["launches"]["visits"] or not solo["launches"]["sweep"] \
            or first["launches"]["sweep"] or not first["launches"]["visits"] \
            or not first["launches"]["matvec"] \
            or any(t["launches"][k] for t in rest for k in solve):
        raise AssertionError("e2e_tile_batch: the solo tile must launch the "
                             "sweep and the batch the visits kernel and the "
                             "matvec, never the sweep: "
                             f"{[t['launches'] for t in rec['tiles']]}")
    warm = rtr["tiles"][1]
    emit("e2e_tile_batch_summary", tiles=batch["tiles"],
         batch_em_s=batch["em_s"], batch_refine_s=batch["refine_s"],
         batch_solve_s=batch["solve_s"],
         s_per_tile=sum(t[k] for t in rec["tiles"][1:] for k in (
             "read_s", "solve_s", "residual_s", "write_s")) / TILE_BATCH,
         batch_launches=first["launches"], tile0_s=solo["wall_s"],
         e2e_rtr_tile1=dict(wall_s=warm["wall_s"], em_s=warm["em_s"],
                            refine_s=warm["refine_s"],
                            launches=warm["launches"]),
         e2e_rtr_tile0_s=rtr["tiles"][0]["wall_s"])
    return rec


def main() -> int:
    smi = phase_env()
    phase_build()
    phase_native()
    coh = phase_coh()
    sweep = phase_sweep()
    matvec = phase_matvec()
    visits = phase_visits()
    predict_mixed = phase_predict_mixed()
    phase_manifold()
    parity = phase_slice_parity()
    obs = observation_e2e()
    # e2e and e2e_diag at one EM iteration, to keep the run in time
    phase_e2e(obs, "e2e", ["-j", "1"], 1, ("coh", "sweep"), em=1)
    # at one EM iteration (as e2e_tile_batch, whose batch it is compared
    # with), to keep the run in time (tile 0 boosted to 6 EM iterations)
    rtr = phase_e2e(obs, "e2e_rtr", ["-j", "5", "--inner", "cg"], 2,
                    ("coh", "sweep", "matvec"), em=1)
    # the station beam at full width: one tile of e2e_rtr's sky and gains
    # simulated through the beam
    beam = phase_e2e_beam(rtr)
    # e2e_rtr's first tile at --dtype-policy bf16: the bf16 sweep
    # instance and the matvec, within ENVELOPE of e2e_rtr's tile 0
    bf16 = phase_e2e_reduced(obs, "e2e_bf16", ["-j", "5", "--inner", "cg"],
                             "bf16", ("coh", "sweep", "matvec"), rtr)
    # the constrained Jones modes on the same observation: the sweep
    # kernel at md = 2, and the sweep and matvec kernels at md = 1 (both
    # at one EM iteration, to keep the run in time)
    e2e_md = {2: phase_e2e(obs, "e2e_diag", ["-j", "1", "--jones", "diag"],
                           1, ("coh", "sweep"), em=1),
              1: phase_e2e(obs, "e2e_phase", ["-j", "5", "--inner", "cg",
                                              "--jones", "phase"], 1,
                           ("coh", "sweep", "matvec"), em=1)}
    # the solve, correction and simulation options on the same
    # observation: -b 1 and -W 1 -J 1 at one EM iteration (boosted to 6
    # on the first tile), and the simulation modes from e2e_rtr's
    # solutions
    bandpass = phase_e2e_bandpass(obs)
    whiten_phase = phase_e2e(obs, "e2e_whiten_phase",
                             ["-j", "5", "--inner", "cg", "-W", "1", "-J",
                              "1", "-k", "0"], 1,
                             ("coh", "sweep", "matvec"), em=1)
    sim = phase_e2e_sim(obs, os.path.join(os.path.dirname(obs[0]),
                                          "e2e_rtr_solutions.txt"))
    # stochastic calibration on the same observation (its first 2 tiles),
    # and stochastic consensus on its first tile
    stochastic = phase_e2e_stochastic(obs)
    st_consensus = phase_e2e_stochastic_consensus(obs)
    shutil.rmtree(os.path.dirname(obs[0]), ignore_errors=True)
    tile_batch = phase_e2e_tile_batch(rtr)
    # one EM iteration, to keep the run in time (tile 0 boosted to 6, its
    # first sweep of groups of 2, then of 4; tile 1 one warm sweep of 4)
    obs16 = observation_e2e("e2e16", NCHUNK16)
    inflight_flags = ["-j", "5", "--inner", "cg", "--inflight",
                      str(N_VISITS)]
    inflight = phase_e2e(obs16, "e2e_inflight", inflight_flags, 2,
                         ("coh", "visits", "matvec"), em=1)
    # its first tile at --dtype-policy f16: the f16 visits instance
    f16 = phase_e2e_reduced(obs16, "e2e_f16_inflight", inflight_flags,
                            "f16", ("coh", "visits", "matvec"), inflight)
    shutil.rmtree(os.path.dirname(obs16[0]), ignore_errors=True)
    # the JAX CLI's default command line (-j 5 --inner chol --kernel xla)
    # on the mixed sky: the split predict and the XLA assembly, at one EM
    # iteration (boosted to 6 on the first tile) to keep the run in time
    mixed = phase_e2e(observation_e2e("e2e_mixed", mixed=True, n_tiles=1),
                      "e2e_mixed", ["-j", "5", "--kernel", "xla"], 1,
                      ("coh",), xla=True, em=1)
    # consensus calibration (the MPI CLI) on 4 full-width subbands, and
    # federated stochastic calibration (-N) on 2
    consensus = phase_e2e_consensus()
    federated = phase_e2e_federated()
    inflight_cons = parity["consensus_rtr_inflight"]["launches"]
    plans = {tag: parity[tag]["launches"] for tag in (
        "consensus_blocked", "consensus_stale", "consensus_time_shard")}

    def plan_launches(kernel):
        """A kernel's launches on the MPI CLI's plan runs."""
        return {f"launches_{tag}": launches[kernel]
                for tag, launches in plans.items()}
    vis = visits[(4, True)]

    def by_md(recs, kernel):
        """A kernel's diag (md = 2) and phase (md = 1) figures: its records
        at K = 4 (and K = 1), and its launches over e2e_diag and
        e2e_phase."""
        out = {}
        for jones, md in MODES:
            r4, r1 = recs[(jones, 4)], recs[(jones, 1)]
            out[f"md{md}"] = dict(
                kernel_us=r4["kernel_us"], kernel_us_k1=r1["kernel_us"],
                kernel_bound_share=r4["kernel_bound_share"],
                kernel_bound_share_k1=r1["kernel_bound_share"],
                ms=r4["ms"], call_ms_k1=r1["call_ms"],
                device_ms=r4["device_ms"], device_ms_k1=r1["device_ms"],
                plain_ms=r4["plain_ms"], bound_ms=r4["bound_ms"],
                bound_ms_k1=r1["bound_ms"], bound_by=r4["bound_by"],
                library_ms=r4["library_ms"],
                max_abs_err=max(r4["max_abs_err"], r1["max_abs_err"]),
                launches_e2e_diag=e2e_md[2]["launches"]["by_md"].get(
                    f"{kernel}_md{md}", 0),
                launches_e2e_phase=e2e_md[1]["launches"]["by_md"].get(
                    f"{kernel}_md{md}", 0))
        return out

    import torch
    kernels = [
        dict(name="coh_points", route="cuda",
             source="sagecal_tpu_torch/csrc/coh.cu",
             replaces="sagecal_tpu/ops/coh_pallas.py:49",
             launches=rtr["launches"]["coh"],
             launches_e2e_mixed=mixed["launches"]["coh"],
             predict_mixed_call_ms=predict_mixed["call_ms"],
             max_abs_err=max(r["max_abs_err"] for r in coh.values()),
             ms=coh["residual"]["ms"], plain_ms=coh["residual"]["plain_ms"],
             bound_ms=coh["residual"]["bound_ms"],
             bound_by=coh["residual"]["bound_by"], library_ms=None,
             device_ms=coh["residual"]["device_ms"],
             kernel_us=coh["residual"]["kernel_us"],
             kernel_bound_share=coh["residual"]["kernel_bound_share"],
             sincos_kernel_us=coh["residual"]["sincos_kernel_us"],
             f64_err_kernel=coh["residual"]["f64_err_kernel"],
             f64_err_plain_f32=coh["residual"]["f64_err_plain_f32"],
             launches_e2e_stochastic=stochastic["launches"]["coh"],
             launches_e2e_bandpass=bandpass["launches"]["coh"],
             launches_e2e_bandpass_by_f=bandpass["launches"]["coh_by_f"],
             launches_e2e_sim=sim["coh_launches"],
             launches_e2e_consensus=consensus["launches"]["coh"],
             launches_e2e_stochastic_consensus=st_consensus["launches"][
                 "coh"],
             launches_e2e_federated=federated["launches"]["coh"],
             launches_federated=parity["federated"]["launches"]["coh"],
             **plan_launches("coh"),
             bands={tag: {k: coh[tag][k] for k in (
                 "F", "B", "step", "kernel_us", "device_ms", "ms",
                 "plain_ms", "bound_ms", "bound_by", "kernel_bound_share",
                 "max_abs_err", "rel_err")} for tag, _ in COH_BANDS},
             device_ms_f1=coh["solve"]["device_ms"],
             kernel_us_f1=coh["solve"]["kernel_us"],
             call_ms_f1=coh["solve"]["ms"],
             bound_ms_f1=coh["solve"]["bound_ms"],
             registers=coh["solve"]["ptxas"]),
        dict(name="sweep_blocks", route="cuda",
             source="sagecal_tpu_torch/csrc/sweep.cu",
             replaces="sagecal_tpu/ops/sweep_pallas.py:395",
             launches=rtr["launches"]["sweep"],
             launches_e2e_whiten_phase=whiten_phase["launches"]["sweep"],
             launches_e2e_bandpass=bandpass["launches"]["sweep"],
             launches_e2e_beam=beam["launches"]["sweep"],
             launches_e2e_consensus=consensus["launches"]["sweep"],
             **plan_launches("sweep"),
             max_abs_err=max(r["max_abs_err"] for r in sweep.values()),
             ms=sweep[4]["ms"], plain_ms=sweep[4]["plain_ms"],
             bound_ms=sweep[4]["bound_ms"], bound_by=sweep[4]["bound_by"],
             library_ms=None, device_ms=sweep[4]["device_ms"],
             device_ms_k1=sweep[1]["device_ms"],
             call_ms_k1=sweep[1]["call_ms"],
             kernel_us=sweep[4]["kernel_us"],
             kernel_us_k1=sweep[1]["kernel_us"],
             registers=sweep[4]["ptxas"], **by_md(sweep, "sweep")),
        dict(name="gn_matvec_blocks", route="cuda",
             source="sagecal_tpu_torch/csrc/matvec.cu",
             replaces="sagecal_tpu/ops/sweep_pallas.py:946",
             launches=rtr["launches"]["matvec"],
             launches_e2e_tile_batch=tile_batch["launches"]["matvec"],
             launches_e2e_whiten_phase=whiten_phase["launches"]["matvec"],
             launches_e2e_beam=beam["launches"]["matvec"],
             launches_e2e_consensus=consensus["launches"]["matvec"],
             launches_consensus_rtr_inflight=inflight_cons["matvec"],
             **plan_launches("matvec"),
             max_abs_err=max(r["max_abs_err"] for r in matvec.values()),
             ms=matvec[4]["ms"], plain_ms=matvec[4]["plain_ms"],
             bound_ms=matvec[4]["bound_ms"], bound_by=matvec[4]["bound_by"],
             library_ms=matvec[4]["library_ms"],
             device_ms=matvec[4]["device_ms"],
             device_ms_k1=matvec[1]["device_ms"],
             call_ms_k1=matvec[1]["call_ms"],
             kernel_us=matvec[4]["kernel_us"],
             kernel_us_k1=matvec[1]["kernel_us"],
             lanes={f"V{V}": {k: matvec[("lanes", V)][k] for k in (
                 "K", "kernel_us", "device_ms", "call_ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms", "max_abs_err")}
                 for V in (TILE_BATCH, N_LANES)},
             registers=matvec[4]["ptxas"], **by_md(matvec, "matvec")),
        dict(name="sweep_blocks_visits", route="cuda",
             source="sagecal_tpu_torch/csrc/sweep.cu",
             replaces="sagecal_tpu/ops/sweep_pallas.py:439",
             launches=inflight["launches"]["visits"],
             launches_e2e_tile_batch=tile_batch["launches"]["visits"],
             launches_consensus_rtr_inflight=inflight_cons["visits"],
             max_abs_err=max(r["max_abs_err"] for r in visits.values()),
             ms=vis["ms"], plain_ms=vis["plain_ms"],
             bound_ms=vis["bound_ms"], bound_by=vis["bound_by"],
             library_ms=None, device_ms=vis["device_ms"],
             kernel_us=vis["kernel_us"],
             kernel_bound_share=vis["kernel_bound_share"],
             serial_ms=vis["serial_ms"],
             device_ms_k1=visits[(1, True)]["device_ms"],
             call_ms_k1=visits[(1, True)]["call_ms"],
             serial_ms_k1=visits[(1, True)]["serial_ms"],
             call_ms_lanes=visits["tile_batch"]["call_ms"],
             device_ms_lanes=visits["tile_batch"]["device_ms"],
             registers=vis["ptxas"], **by_md(visits, "visits")),
    ]
    # the bf16 and f16 instances of the sweep and visits kernels, each
    # with its launches on the path that runs it: e2e_bf16 (sweep bf16),
    # slice_parity f16_j1 (sweep f16), bf16_inflight_rtr (visits bf16),
    # e2e_f16_inflight (visits f16)
    st_runs = {("sweep", "bf16"): ("e2e_bf16", bf16["launches"]),
               ("sweep", "f16"): ("slice_parity f16_j1",
                                  parity["f16_j1"]["launches"]),
               ("visits", "bf16"): ("slice_parity bf16_inflight_rtr",
                                    parity["bf16_inflight_rtr"]["launches"]),
               ("visits", "f16"): ("e2e_f16_inflight", f16["launches"])}
    for (kind, policy), (run, launches) in st_runs.items():
        recs = sweep if kind == "sweep" else visits
        full = recs[(policy, "full", 4)]
        entry = dict(
            name=("sweep_blocks" if kind == "sweep"
                  else "sweep_blocks_visits") + "_" + policy,
            route="cuda", source="sagecal_tpu_torch/csrc/sweep.cu",
            replaces="sagecal_tpu/ops/sweep_pallas.py:"
            + ("395" if kind == "sweep" else "439"),
            launches=launches["by_st"].get(f"{kind}_{policy}", 0),
            launches_run=run,
            max_abs_err=max(r["max_abs_err"] for k, r in recs.items()
                            if isinstance(k, tuple) and k[0] == policy),
            ms=full["ms"], plain_ms=full["plain_ms"],
            bound_ms=full["bound_ms"], bound_by=full["bound_by"],
            library_ms=None, device_ms=full["device_ms"],
            kernel_us=full["kernel_us"],
            kernel_bound_share=full["kernel_bound_share"],
            row_bytes=full.get("row_bytes"), K=4,
            registers={k: v for k, v in full["ptxas"].items()
                       if k.endswith(("__nv_bfloat16>" if policy == "bf16"
                                      else "__half>"))})
        for jones, md in MODES:
            r = recs[(policy, jones, 4)]
            entry[f"md{md}"] = dict(
                kernel_us=r["kernel_us"], ms=r["ms"], plain_ms=r["plain_ms"],
                device_ms=r["device_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"],
                kernel_bound_share=r["kernel_bound_share"],
                max_abs_err=r["max_abs_err"])
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']}: no launch on {run}")
        kernels.append(entry)
    shutil.rmtree(WORK, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
