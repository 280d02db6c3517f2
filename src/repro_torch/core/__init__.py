"""The port's copy of the ParaDL core (``repro.core``), the part ported so
far: oracle.py (Table-3 projections), sweep (the vectorized strategy × scale
lattice), advisor.py (strategy selection), hardware.py (α–β system models,
and ``cuda_device_model`` for one card), cluster.py (ClusterSpec),
partition.py (pipeline stage cuts), layer_stats.py (Table-2 tensor stats
over the port's configs), calibration.py and validation.py (the paper's
Fig. 3 at p = 1), and autotune (the oracle-in-the-loop tuner that
``launch/train.py --strategy auto`` deploys). The numpy modules are copies
of the reference's; the XLA-bound roofline and HLO analysis come with a
later slice. As in the reference, ``sweep`` and ``autotune`` name the
functions here: reach the subpackages by ``importlib.import_module``.
"""
from .cluster import (ClusterSpec, Measurement, Torus, add_cluster_args,
                      parse_phi_table, parse_sigma_table)
from .hardware import (Level, PAPER_V100_CLUSTER, SystemModel, TPU_V5E_POD,
                       cpu_host_model, cuda_device_model)
from .layer_stats import LayerStat, stats_for
from .oracle import (OracleConfig, Projection, STRATEGY_NAMES, StatTable,
                     TimeModel, precompute, project, project_all,
                     seq_flops_coeffs)
from .sweep import (SweepResult, all_switch_combos, factor_pairs,
                    parse_p_grid, sweep)
from .advisor import Recommendation, advise, advise_groups, breakdown_table
from .autotune import TunedPlan, autotune, plan_for_arch
from .calibration import (calibrate_compute, calibrate_host_system,
                          measure_hbm_bw, time_fn)
from .validation import (ValidationPoint, accuracy_report, measure_step,
                         validate)
