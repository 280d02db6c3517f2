"""ClusterSpec — one first-class machine description (DESIGN.md §11); the
port's copy of ``repro.core.cluster``.

The paper's oracle is only as good as its machine model, yet until this
module the description was scattered across four loose objects: the α–β
``SystemModel`` (hardware.py, no topology), the φ/σ tables living on
``OracleConfig`` (oracle.py), copy-pasted ``--phi``/``--sigma`` CLI parsing,
and a calibration harness (calibration.py) whose measurements never flowed
back into projections. ``ClusterSpec`` owns all four concerns:

  * interconnect ``Level``s with Hockney α/β, keyed by mesh axis,
  * per-PE compute (peak FLOP/s, HBM bandwidth, memory capacity),
  * the physical **torus topology** — per-dimension extents plus which
    dimensions the model axis may occupy (FlexFlow-style placement
    constraint: a ring collective needs a physical ring, so the model axis
    must embed within ONE torus dimension; a pipeline chain may snake),
  * the contention φ and overlap-efficiency σ tables the oracle's terms
    consume, with ``fitted_from(measurements)`` ingesting the calibration
    harness output (core/calibration.py) so measured runs close the loop
    back into projections. The port's calibration measures one card
    (p = 1); the multi-rank measurements come with the parallel slice, and
    ``fitted_from`` reads measurement records from either package.
  * the machine that survives a lost torus slice (``ClusterSpec.degraded``,
    ``Torus.without_slice``), which the elastic runtime re-tunes on
    (``runtime/elastic.py``).

Everything here is numpy-only, so the oracle runs without a device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace

import numpy as np

from .hardware import (Level, PAPER_V100_CLUSTER, SystemModel, TPU_V5E_POD,
                       cpu_host_model)

# interconnect levels the oracle's α–β terms consume today (the pod/DCI hop
# is modeled by roofline.py but no Table-3 term crosses it separately yet)
PHI_LEVELS = ("data", "model")


# ---------------------------------------------------------------------------
# CLI table parsing (one home; sweep/autotune re-use it via from_cli_args)
# ---------------------------------------------------------------------------

def _parse_level_table(spec, flag: str):
    """'data=2.0,model=1.2' → ((level, value), ...); None/empty → None.
    Rejects unknown level names — a typo (or a level the α–β terms do not
    yet consume, like the pod/DCI hop) must not silently change nothing."""
    if not spec:
        return None
    out = []
    for part in spec.split(","):
        lvl, _, val = part.partition("=")
        if not val:
            raise ValueError(f"{flag} entry {part!r} is not LEVEL=VALUE")
        lvl = lvl.strip()
        if lvl not in PHI_LEVELS:
            raise ValueError(f"{flag} level {lvl!r} is not consumed by the "
                             f"oracle; known levels: {PHI_LEVELS}")
        out.append((lvl, float(val)))
    return tuple(out)


def parse_phi_table(spec):
    """Contention table for OracleConfig.phi_levels (the paper's single
    phi_hybrid constant applies when absent)."""
    return _parse_level_table(spec, "--phi")


def parse_sigma_table(spec):
    """Overlap-efficiency table for OracleConfig.sigma_levels
    (oracle.SIGMA_DEFAULTS apply when absent)."""
    return _parse_level_table(spec, "--sigma")


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Torus:
    """Physical torus/mesh: per-dimension extents + model-axis placement.

    ``model_dims`` lists the dimension indices the model axis may occupy;
    ``None`` means any single dimension, ``()`` means none (model axis
    confined to width 1 — e.g. every wired dim carries DCI-grade links).

    The embedding rule (documented, deliberately conservative):
      * the model axis runs **ring** collectives (allgather/allreduce/halo),
        so a model width p2 > 1 must embed as a ring within ONE allowed
        dimension: ∃ allowed d with dims[d] % p2 == 0. Spanning two torus
        dimensions would fold two physical rings into one logical ring,
        which the α–β model (one link per hop) does not describe.
      * a 2D model GRID (summa: p2 = p2r·p2c) embeds each grid dimension
        as a ring within its own **distinct** allowed torus dimension:
        ∃ allowed i ≠ j with dims[i] % p2r == 0 and dims[j] % p2c == 0.
        Row and column rings then never share links, so each carries its
        own α/β (ClusterSpec may price the row hop as a "model2" level).
        Degenerate grids (p2r == 1 or p2c == 1) collapse to the 1D rule.
      * the pipeline "model" axis is a **chain** (P2P only); a Hamiltonian
        path snakes across dimensions freely, so pipeline is exempt from
        the one-dimension rule.
      * the machine is tiled by identical (p1, p2) blocks, so p1·p2 must
        divide the torus size.
    """

    dims: tuple
    model_dims: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if any(d < 1 for d in self.dims) or not self.dims:
            raise ValueError(f"torus extents must be >= 1: {self.dims}")
        if self.model_dims is not None:
            md = tuple(sorted(set(int(d) for d in self.model_dims)))
            if any(d < 0 or d >= len(self.dims) for d in md):
                raise ValueError(f"model_dims {md} out of range for "
                                 f"{len(self.dims)}-d torus {self.dims}")
            object.__setattr__(self, "model_dims", md)

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    def __str__(self) -> str:
        t = "x".join(str(d) for d in self.dims)
        if self.model_dims is None:
            return f"({t})-torus"
        return f"({t})-torus[model dims {list(self.model_dims)}]"

    def model_widths(self) -> tuple:
        """Feasible model-axis ring widths: divisors of any allowed dim."""
        dims_ok = (range(len(self.dims)) if self.model_dims is None
                   else self.model_dims)
        ws = {1}
        for d in dims_ok:
            e = self.dims[d]
            ws |= {k for k in range(1, e + 1) if e % k == 0}
        return tuple(sorted(ws))

    def grid_pairs(self) -> tuple:
        """Feasible (p2r, p2c) model-grid embeddings (see the class
        docstring): each grid dim rings within its own distinct allowed
        torus dim (ordered pairs — row and column hops may differ in
        speed), plus the degenerate grids the 1D rule already admits."""
        dims_ok = tuple(range(len(self.dims)) if self.model_dims is None
                        else self.model_dims)
        pairs = {(1, 1)}
        for w in self.model_widths():
            pairs |= {(1, w), (w, 1)}
        divs = {d: tuple(k for k in range(1, self.dims[d] + 1)
                         if self.dims[d] % k == 0) for d in dims_ok}
        for i in dims_ok:
            for j in dims_ok:
                if i != j:
                    pairs |= {(r, c) for r in divs[i] for c in divs[j]}
        return tuple(sorted(pairs))

    def split_mask(self, p, p1, p2, strategy: str | None = None,
                   p2r=None, p2c=None):
        """Vectorized feasibility of (p, p1, p2) lattice points (see the
        class docstring for the embedding rule). ``strategy`` exempts
        'pipeline' (chain, not ring) from the one-dimension rule and
        checks 'summa' points against the 2D grid embeddings
        (``grid_pairs``; the (p2r, p2c) lattice columns must be passed)."""
        p = np.asarray(p, np.int64)
        p2 = np.asarray(p2, np.int64)
        fits = (p >= 1) & (self.size % np.maximum(p, 1) == 0)
        if strategy == "pipeline":
            return fits
        if strategy == "summa":
            r = np.asarray(1 if p2r is None else p2r, np.int64)
            c = np.asarray(1 if p2c is None else p2c, np.int64)
            enc = r * np.int64(2 ** 32) + c
            ok = np.array([ri * 2 ** 32 + ci for ri, ci in self.grid_pairs()],
                          np.int64)
            return fits & np.isin(enc, ok)
        ring_ok = np.isin(p2, np.asarray(self.model_widths(), np.int64))
        return fits & ring_ok

    def limit_str(self, strategy: str) -> str:
        if strategy == "pipeline":
            return f"topology: p must tile the {self} ({self.size} PEs)"
        if strategy == "summa":
            return (f"topology: model grid must embed (row, col) rings in "
                    f"two distinct dims of {self}")
        return (f"topology: model axis must ring within one dim of {self} "
                f"(widths {list(self.model_widths())})")

    def to_json(self) -> dict:
        return {"dims": list(self.dims),
                "model_dims": (None if self.model_dims is None
                               else list(self.model_dims))}

    @classmethod
    def from_json(cls, d: dict) -> "Torus":
        md = d.get("model_dims")
        return cls(tuple(d["dims"]), None if md is None else tuple(md))

    @classmethod
    def parse(cls, spec: str, model_dims: str | None = None) -> "Torus":
        """'4x2' (+ optional model-dims '0' / '0,1' / '' for none)."""
        dims = tuple(int(x) for x in spec.lower().split("x"))
        if model_dims is None:
            return cls(dims)
        md = tuple(int(x) for x in model_dims.split(",") if x.strip())
        return cls(dims, md)

    def without_slice(self, dim: int = 0, count: int = 1) -> "Torus":
        """The torus that survives losing ``count`` hyperplanes of ``dim``
        (slice death: every PE with that coordinate is gone, so the extent
        shrinks — the surviving machine is still a torus). Dimensions that
        collapse to extent 1 are dropped and the model-axis placement
        constraint is re-indexed onto the surviving dimensions; a model
        dim that vanished leaves the model axis confined to width 1."""
        if not 0 <= dim < len(self.dims):
            raise ValueError(f"torus has no dim {dim}: {self.dims}")
        extent = self.dims[dim] - count
        if extent < 1:
            raise ValueError(
                f"cannot drop {count} slice(s) from dim {dim} of {self}")
        dims = list(self.dims)
        dims[dim] = extent
        keep = ([i for i, e in enumerate(dims) if e > 1]
                or [int(np.argmax(dims))])
        remap = {old: new for new, old in enumerate(keep)}
        md = self.model_dims
        if md is not None:
            md = tuple(remap[d] for d in md if d in remap)
        return Torus(tuple(dims[i] for i in keep), md)


# ---------------------------------------------------------------------------
# Calibration measurements (what fitted_from ingests)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Measurement:
    """One calibration observation, tagged by interconnect level.

    kind = "collective": timed ring collective at several message sizes —
        fits Hockney α/β (pattern 'ar': T = 2(p−1)(α + m/p·β);
        'ag'/'rs'/'a2a': T = (p−1)(α + m/p·β)).
    kind = "contention": a saturating collective alone vs ``flows``
        concurrent copies sharing the level — fits φ = shared/alone
        (paper §4.3 self-contention; clamped into [1, flows]).
    kind = "overlap": independent compute and comm timed separately and
        fused — fits σ = (comp + comm − both) / min(comp, comm), the
        fraction of the overlap window actually hidden (DESIGN.md §10;
        clamped into [0, 1]).
    """

    level: str
    kind: str
    pattern: str = "ar"
    p: int = 0
    nbytes: tuple = ()
    seconds: tuple = ()
    alone_s: float = 0.0
    shared_s: float = 0.0
    flows: int = 2
    comp_s: float = 0.0
    comm_s: float = 0.0
    both_s: float = 0.0

    def to_json(self) -> dict:
        d = {"level": self.level, "kind": self.kind}
        if self.kind == "collective":
            d.update(pattern=self.pattern, p=self.p,
                     nbytes=list(self.nbytes), seconds=list(self.seconds))
        elif self.kind == "contention":
            d.update(alone_s=self.alone_s, shared_s=self.shared_s,
                     flows=self.flows)
        elif self.kind == "overlap":
            d.update(comp_s=self.comp_s, comm_s=self.comm_s,
                     both_s=self.both_s)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Measurement":
        d = dict(d)
        if "nbytes" in d:
            d["nbytes"] = tuple(d["nbytes"])
        if "seconds" in d:
            d["seconds"] = tuple(d["seconds"])
        return cls(**d)


def _ring_factor(pattern: str, p: int) -> float:
    return 2.0 * (p - 1) if pattern == "ar" else float(p - 1)


def _fit_alpha_beta(ms: list) -> tuple:
    """Least-squares Hockney fit over 'collective' measurements of one
    level. Returns (alpha, beta, relative rms residual)."""
    rows, ts = [], []
    for m in ms:
        f = _ring_factor(m.pattern, m.p)
        for nbytes, t in zip(m.nbytes, m.seconds):
            rows.append([f, f / m.p * nbytes])
            ts.append(t)
    A, t = np.array(rows, np.float64), np.array(ts, np.float64)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha = float(max(coef[0], 1e-9))
    beta = float(max(coef[1], 1e-12))
    pred = A @ np.array([alpha, beta])
    resid = float(np.linalg.norm(pred - t) / max(np.linalg.norm(t), 1e-30))
    return alpha, beta, resid


# ---------------------------------------------------------------------------
# ClusterSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterSpec:
    """First-class machine description: levels + compute + topology + φ/σ.

    Frozen and hashable (the oracle memoizes per ``SystemModel``), built
    from a ``SystemModel`` (``from_system``), a named preset (``of``), CLI
    flags (``from_cli_args``), a JSON artifact (``from_json``), or measured
    runs (``fitted_from``). ``.system`` projects back down to the α–β
    ``SystemModel`` every legacy entry point consumes, so a ClusterSpec is
    a one-argument swap anywhere a system model went before.
    """

    name: str
    levels: tuple                        # ((axis, Level), ...)
    peak_flops: float
    hbm_bw: float
    mem_capacity: float
    compute_efficiency: float
    topology: Torus | None = None
    phi: tuple | None = None             # ((level, φ), ...) or None
    sigma: tuple | None = None           # ((level, σ), ...) or None
    fit_residuals: tuple = field(default=(), compare=False)

    # -- projections ---------------------------------------------------------

    @property
    def system(self) -> SystemModel:
        """The α–β SystemModel view (equal by value, memo-cache friendly)."""
        return SystemModel(
            name=self.name, peak_flops=self.peak_flops, hbm_bw=self.hbm_bw,
            mem_capacity=self.mem_capacity,
            compute_efficiency=self.compute_efficiency, levels=self.levels)

    def level(self, axis: str) -> Level:
        for name, lvl in self.levels:
            if name == axis:
                return lvl
        return self.levels[-1][1]

    def oracle_kw(self) -> dict:
        """The OracleConfig keywords this cluster owns (φ/σ tables)."""
        kw = {}
        if self.phi is not None:
            kw["phi_levels"] = self.phi
        if self.sigma is not None:
            kw["sigma_levels"] = self.sigma
        return kw

    def oracle_config(self, B: int, D: int | None = None, **kw):
        """An OracleConfig carrying this cluster's φ/σ tables. Explicit
        keywords win over the cluster's tables."""
        from .oracle import OracleConfig
        merged = self.oracle_kw()
        merged.update(kw)
        return OracleConfig(B=B, D=D if D is not None else B, **merged)

    def degraded(self, dim: int = 0, count: int = 1) -> "ClusterSpec":
        """The machine that survives losing ``count`` slices of torus
        ``dim``: same interconnect levels, compute, and φ/σ tables, with
        the topology shrunk via ``Torus.without_slice`` (model-axis
        constraints re-indexed). This is the ClusterSpec the elastic
        controller re-runs the tuner on (runtime/elastic.py). Without a
        topology there is no slice structure to shrink — the spec is
        returned unchanged and the caller shrinks p itself."""
        if self.topology is None:
            return self
        name = (self.name if self.name.endswith("-degraded")
                else f"{self.name}-degraded")
        return replace(self, name=name,
                       topology=self.topology.without_slice(dim, count))

    def describe(self) -> str:
        lv = ", ".join(
            f"{ax}: α={l.alpha:.2e}s β⁻¹={1 / l.beta / 1e9:.1f}GB/s"
            for ax, l in self.levels)
        parts = [f"ClusterSpec[{self.name}]: {lv}"]
        if self.topology is not None:
            parts.append(f"  topology {self.topology}")
        if self.phi:
            parts.append("  φ " + ", ".join(f"{k}={v:.2f}"
                                            for k, v in self.phi))
        if self.sigma:
            parts.append("  σ " + ", ".join(f"{k}={v:.2f}"
                                            for k, v in self.sigma))
        return "\n".join(parts)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_system(cls, sysm: SystemModel, *, topology: Torus | None = None,
                    phi=None, sigma=None, name: str | None = None
                    ) -> "ClusterSpec":
        return cls(name=name or sysm.name, levels=sysm.levels,
                   peak_flops=sysm.peak_flops, hbm_bw=sysm.hbm_bw,
                   mem_capacity=sysm.mem_capacity,
                   compute_efficiency=sysm.compute_efficiency,
                   topology=topology, phi=phi, sigma=sigma)

    @classmethod
    def of(cls, name: str) -> "ClusterSpec":
        """Named presets mirroring hardware.py. Topology stays None (i.e.
        unconstrained) so legacy projections are bit-identical; pass
        ``topology=`` / ``--topology`` to constrain plan search."""
        try:
            return cls.from_system(_NAMED_SYSTEMS[name])
        except KeyError:
            raise KeyError(f"unknown cluster {name!r}; "
                           f"known: {sorted(_NAMED_SYSTEMS)}") from None

    @classmethod
    def coerce(cls, obj) -> "ClusterSpec | None":
        """None | name | SystemModel | ClusterSpec → ClusterSpec (or None)."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            return cls.of(obj)
        if isinstance(obj, SystemModel):
            return cls.from_system(obj)
        raise TypeError(f"cannot build a ClusterSpec from {type(obj)}")

    @classmethod
    def from_cli_args(cls, args) -> "ClusterSpec":
        """Build the ClusterSpec an argparse namespace describes (the flags
        ``add_cluster_args`` attached; missing attributes default sanely).
        This is the one home for the --system/--phi/--sigma/--topology
        wiring both CLIs used to copy-paste."""
        art = getattr(args, "cluster", None)
        if art:
            spec = cls.from_json(art)
        else:
            spec = cls.of(getattr(args, "system", None) or "paper")
        phi = parse_phi_table(getattr(args, "phi", None))
        sigma = parse_sigma_table(getattr(args, "sigma", None))
        topo_s = getattr(args, "topology", None)
        md = getattr(args, "model_dims", None)
        if topo_s:
            topo = Torus.parse(topo_s, md)
        elif md is not None:
            # --model-dims without --topology must not silently change
            # nothing (same rule the level tables enforce for typos); it
            # can however re-constrain a topology the artifact carries
            if spec.topology is None:
                raise ValueError(
                    "--model-dims requires --topology (or a --cluster "
                    "artifact that defines one)")
            topo = Torus.parse("x".join(str(d) for d in spec.topology.dims),
                               md)
        else:
            topo = spec.topology
        return replace(spec, phi=phi if phi is not None else spec.phi,
                       sigma=sigma if sigma is not None else spec.sigma,
                       topology=topo)

    @classmethod
    def fitted_from(cls, measurements, base=None,
                    name: str | None = None) -> "ClusterSpec":
        """Fit per-level α/β (Hockney least squares), φ (contention) and σ
        (overlap efficiency) from calibration measurements — the
        ROADMAP's "fit both per interconnect level from measured runs".

        ``measurements``: iterable of ``Measurement`` (or their dicts).
        ``base``: the spec whose compute/topology fields carry over and
        whose levels stand wherever no measurement covers an axis.
        """
        base = cls.coerce(base) or cls.of("host")
        ms = [Measurement.from_json(m) if isinstance(m, dict) else m
              for m in measurements]
        by = {}
        for m in ms:
            by.setdefault((m.level, m.kind), []).append(m)
        residuals = []
        levels, phi, sigma = dict(base.levels), {}, {}
        for (lvl, kind), grp in sorted(by.items()):
            if kind == "collective":
                a, b, r = _fit_alpha_beta(grp)
                levels[lvl] = Level(f"fit-{lvl}", alpha=a, beta=b)
                residuals.append((f"{lvl}/alpha_beta", r))
            elif kind == "contention":
                vals = [min(max(m.shared_s / max(m.alone_s, 1e-12), 1.0),
                            float(m.flows)) for m in grp]
                phi[lvl] = float(np.median(vals))
                residuals.append((f"{lvl}/phi_spread",
                                  float(np.ptp(vals)) if len(vals) > 1
                                  else 0.0))
            elif kind == "overlap":
                vals = [min(max((m.comp_s + m.comm_s - m.both_s)
                                / max(min(m.comp_s, m.comm_s), 1e-12), 0.0),
                            1.0) for m in grp]
                sigma[lvl] = float(np.median(vals))
                residuals.append((f"{lvl}/sigma_spread",
                                  float(np.ptp(vals)) if len(vals) > 1
                                  else 0.0))
            else:
                raise ValueError(f"unknown measurement kind {kind!r}")
        base_axes = [ax for ax, _ in base.levels]
        extra = [ax for ax in sorted(levels) if ax not in base_axes]
        return replace(
            base, name=name or f"{base.name}-fitted",
            levels=tuple((ax, levels[ax]) for ax in base_axes + extra),
            phi=tuple(sorted(phi.items())) if phi else base.phi,
            sigma=tuple(sorted(sigma.items())) if sigma else base.sigma,
            fit_residuals=tuple(residuals))

    def fingerprint(self) -> str:
        """Short stable digest of the machine description (12 hex chars).

        Keys tuned-kernel artifacts (experiments/kernel_tune.json): a cache
        written under one machine description is invalid under another —
        different VMEM pressure / rooflines move the block-size optimum.
        ``fit_residuals`` is excluded (diagnostic only, ``compare=False``),
        so a re-calibration that lands on the same constants keeps its
        tuned blocks."""
        import hashlib
        d = self.to_json()
        d.pop("fit_residuals", None)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    # -- JSON artifact -------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "levels": {ax: {"alpha": l.alpha, "beta": l.beta, "name": l.name}
                       for ax, l in self.levels},
            "peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
            "mem_capacity": self.mem_capacity,
            "compute_efficiency": self.compute_efficiency,
            "topology": (None if self.topology is None
                         else self.topology.to_json()),
            "phi": dict(self.phi) if self.phi else None,
            "sigma": dict(self.sigma) if self.sigma else None,
            "fit_residuals": dict(self.fit_residuals),
        }

    @classmethod
    def from_json(cls, d) -> "ClusterSpec":
        """Dict, JSON string, or path to a JSON artifact."""
        if isinstance(d, str):
            if d.lstrip().startswith("{"):
                d = json.loads(d)
            else:
                with open(d) as f:
                    d = json.load(f)
        levels = tuple(
            (ax, Level(v.get("name", ax), alpha=v["alpha"], beta=v["beta"]))
            for ax, v in d["levels"].items())
        topo = d.get("topology")
        return cls(
            name=d["name"], levels=levels, peak_flops=d["peak_flops"],
            hbm_bw=d["hbm_bw"], mem_capacity=d["mem_capacity"],
            compute_efficiency=d["compute_efficiency"],
            topology=None if topo is None else Torus.from_json(topo),
            phi=tuple(sorted(d["phi"].items())) if d.get("phi") else None,
            sigma=(tuple(sorted(d["sigma"].items()))
                   if d.get("sigma") else None),
            fit_residuals=tuple(sorted(d.get("fit_residuals", {}).items())))


_NAMED_SYSTEMS = {"paper": PAPER_V100_CLUSTER, "tpu": TPU_V5E_POD,
                  "host": cpu_host_model()}


# ---------------------------------------------------------------------------
# CLI wiring (the one home for the flags sweep/autotune used to copy-paste)
# ---------------------------------------------------------------------------

def add_cluster_args(ap, default_system: str = "paper") -> None:
    """Attach the machine-description flags to an argparse parser; pair
    with ``ClusterSpec.from_cli_args``."""
    g = ap.add_argument_group("cluster (machine description)")
    g.add_argument("--system", default=default_system,
                   choices=sorted(_NAMED_SYSTEMS),
                   help="named cluster preset (hardware.py α–β models)")
    g.add_argument("--cluster", default=None, metavar="JSON",
                   help="fitted ClusterSpec artifact (e.g. experiments/"
                        "cluster_fit.json); overrides --system")
    g.add_argument("--phi", default=None, metavar="LVL=PHI[,LVL=PHI...]",
                   help="per-interconnect contention table, e.g. "
                        "'data=2.0,model=1.2' (default: the paper's single "
                        "phi_hybrid=2.0 on the hybrid gradient exchange)")
    g.add_argument("--sigma", default=None, metavar="LVL=SIG[,LVL=SIG...]",
                   help="per-interconnect overlap efficiency table, e.g. "
                        "'model=0.9,data=0.8' (the defaults)")
    g.add_argument("--topology", default=None, metavar="DxD[xD...]",
                   help="physical torus extents, e.g. '4x2'; hybrid plans "
                        "whose model axis cannot ring within one dim are "
                        "pruned, not silently deployed")
    g.add_argument("--model-dims", default=None, metavar="I[,I...]",
                   help="torus dim indices the model axis may occupy "
                        "(default: any single dim; '' for none)")


