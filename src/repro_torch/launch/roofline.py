"""Roofline terms of a dry-run record on the NVIDIA H100 (the port of
`repro.launch.roofline`).

Three terms per (arch x shape x mesh), in seconds a step, each a lower
bound on one rank:

  compute    = flops            / PEAK_FLOPS (bf16 tensor cores; the
               BCPNN tick, whose cell math is float32, at FP32_FLOPS)
  memory     = bytes accessed   / HBM_BW
  collective = NVLink bytes     / NVLINK_BW + NIC bytes / NIC_BW

The flops, bytes and collective bytes are one rank's, from
`launch.dryrun`: flops and bytes counted over the operations the port's
own step issues on meta tensors (matmuls and attention flops; the bytes
each operation reads and writes), collective bytes from the collectives
it issues. The JAX package reads these from XLA (cost analysis and the
optimized HLO text); its HLO parsers do not carry over, and `analyze`
takes the dry run's record instead. Collectives are priced by the mesh
axis they run over: a group that stays within one node of 8 cards runs
over NVLink, a group that spans nodes at one NIC port. On the production
meshes (16, 16) and (2, 16, 16) over nodes of 8 consecutive ranks both
"model" (16 consecutive ranks) and "data" / "pod" (strided) span nodes,
so every collective there is priced at the NIC; on one node every axis
is NVLink's.

`model_flops`, `outside_loop_costs`, `corrected_costs` and `scan_factor`
are the JAX package's arithmetic. The port runs every layer (no scan), so
its dry run records a scan factor of 1.0 and applies no correction; the
functions stay for records of the JAX package's kind.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, data sheet
# figures; a card capped lower runs below them
PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense tensor cores
FP32_FLOPS = 67e12           # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # B/s, HBM3
NVLINK_BW = 450e9            # B/s a direction, NVLink 4, within a node of 8
NIC_BW = 50e9                # B/s, one 400 Gb/s port, across nodes
NODE_RANKS = 8               # cards a node joined by NVLink

_PEAKS = {"bf16": "PEAK_FLOPS", "float32": "FP32_FLOPS"}


def scan_factor(cfg, extra_repeats: int = 0) -> float:
    """Weighted trip count of the scanned layer stack (the JAX package's).

    F = sum_seg(repeats * blocks) / sum_seg(blocks): multiplying the
    once-counted scan bodies by F reconstructs total block executions.
    extra_repeats adds non-stack scans (e.g. the whisper encoder).
    """
    from repro_torch.models.transformer import build_stack_spec
    segs = build_stack_spec(cfg)
    blocks = sum(len(pat) for pat, _ in segs)
    execs = sum(len(pat) * rep for pat, rep in segs)
    if extra_repeats:
        blocks += 1
        execs += extra_repeats
    return execs / max(blocks, 1)


def outside_loop_costs(cfg, shape_kind: str, batch: int, seq: int,
                       chips: int, tp: int = 16):
    """Analytic per-chip flops/bytes of the NON-scanned part of a step
    (embedding + LM head + loss + optimizer), as the JAX package computes
    them.

    train : head fwd+bwd ~ 6*B*S*D*V flops; optimizer ~ 12N flops,
            ~28N bytes f32 traffic (p,mu,nu r/w + grads r)
    serve : head fwd 2*tokens*D*V; no optimizer
    Per-chip: matmuls divide by all chips (fully sharded); optimizer traffic
    divides by the sharding of each buffer (params/grads: TP; moments: ZeRO
    over all chips).
    """
    D, V = cfg.d_model, cfg.vocab
    N = cfg.param_count()
    if shape_kind == "train":
        tokens = batch * seq
        flops = 6.0 * tokens * D * V / chips + 12.0 * N / chips
        byts = (12.0 * N / tp           # params+grads r/w, TP-sharded f32
                + 16.0 * N / chips)     # mu/nu r/w, ZeRO over all chips
        flops += 2.0 * tokens * D / chips        # embed gather
    else:
        # prefill emits logits ONLY for the last position; decode for the
        # single new token — the head is B tokens either way
        flops = 2.0 * batch * D * V / chips
        byts = 4.0 * V * D / tp                   # head weights read
    return flops, byts


def corrected_costs(cfg, shape_kind: str, raw_flops: float, raw_bytes: float,
                    batch: int, seq: int, chips: int, factor: float,
                    tp: int = 16):
    """Scan-corrected per-chip (flops, bytes):
         corrected = outside + (raw - outside) * factor
    clamped so a mis-estimated outside part can't push the in-loop share
    negative."""
    of, ob = outside_loop_costs(cfg, shape_kind, batch, seq, chips, tp)
    of = min(of, raw_flops)
    ob = min(ob, raw_bytes)
    return (of + (raw_flops - of) * factor,
            ob + (raw_bytes - ob) * factor)


@dataclasses.dataclass
class Roofline:
    """One cell's roofline on one rank. ``coll_bytes`` are priced at
    NVLINK_BW, ``coll_nic_bytes`` at NIC_BW; ``peak`` names the compute
    peak ("bf16" or "float32"). The constants are read at each call."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per chip
    hlo_bytes: float            # per chip
    coll_bytes: float           # per chip, within a node
    model_flops: float          # useful-work flops per step (global)
    coll_detail: dict | None = None
    coll_nic_bytes: float = 0.0  # per chip, across nodes
    peak: str = "bf16"

    @property
    def peak_flops(self):
        return globals()[_PEAKS[self.peak]]

    @property
    def t_compute(self):
        return self.hlo_flops / self.peak_flops

    @property
    def t_memory(self):
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / NVLINK_BW + self.coll_nic_bytes / NIC_BW

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_step(self):
        # perfectly-overlapped lower bound: max of the three terms
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self):
        """MODEL_FLOPS / (global counted flops) — remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_at_roofline(self):
        """Model-flop utilization if the step ran exactly at t_step."""
        return self.model_flops / (self.t_step * self.chips * self.peak_flops) \
            if self.t_step else 0.0

    def row(self):
        return (f"{self.arch:28s} {self.shape:12s} {self.mesh:10s} "
                f"{self.t_compute*1e3:9.3f} {self.t_memory*1e3:9.3f} "
                f"{self.t_collective*1e3:9.3f}  {self.bottleneck:10s} "
                f"{self.useful_fraction:7.3f} {self.mfu_at_roofline:6.3f}")

    HEADER = (f"{'arch':28s} {'shape':12s} {'mesh':10s} "
              f"{'t_comp_ms':>9s} {'t_mem_ms':>9s} {'t_coll_ms':>9s}  "
              f"{'bottleneck':10s} {'useful':>7s} {'MFU@rl':>6s}")


def model_flops(cfg, shape_name: str, n_tokens: int, train: bool) -> float:
    """6*N*D (train) / 2*N*D (inference) with MoE active params."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    return mult * n * n_tokens


def analyze(rec: dict) -> Roofline:
    """The `Roofline` of a `launch.dryrun` record: its one rank's flops
    and bytes accessed, its collective bytes by where they run
    (``collectives["nvlink"]`` / ``["nic"]``), float32 peak for a BCPNN
    tick (bf16 otherwise)."""
    coll = rec.get("collectives", {})
    return Roofline(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                    chips=rec["chips"], hlo_flops=rec["cost"]["flops"],
                    hlo_bytes=rec["cost"]["bytes accessed"],
                    coll_bytes=coll.get("nvlink", 0.0),
                    coll_nic_bytes=coll.get("nic", 0.0),
                    model_flops=rec["model_flops"], coll_detail=coll,
                    peak="float32" if rec["arch"].startswith("bcpnn")
                    else "bf16")
