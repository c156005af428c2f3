"""Typed configuration for tpurec_torch.

The port's own copy of ``tpurec/config.py``: the same frozen dataclasses
with the same fields and defaults, so a checkpoint written by the JAX
package (whose payload carries ``config_to_dict(cfg)``) loads unchanged
through :func:`config_from_dict`.  Field comments describe the settings
as the JAX package uses them; the port's serving slice reads ``model``,
``cdc``, ``data.hash_buckets`` and ``train.compute_dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the model zoo.

    Defaults follow the reference's config.py:12-60 and main.py:22-27.
    """

    model: str = "deepfm"
    embed_dim: int = 16                       # config.py:12
    dropout: float = 0.2                      # model ctors' default
    # embedding-table init std; None = N(0,1) (torch nn.Embedding default,
    # layer.py:140 — saturates initial FM/linear logits, hence DeepFM's slow
    # first epochs).  Opt-in smaller std is a documented divergence.
    embed_init_std: Optional[float] = None

    # common MLP dims for dcn/dcnv2/autoint (config.py:18)
    mlp_dims: Tuple[int, ...] = (256, 128, 64)
    # common tower dims for pepnet/epnet/star/adl/hinet (config.py:21)
    tower_dims: Tuple[int, ...] = (256, 128, 64, 32)

    # aux heads (config.py:24-28); use_atten=True is the reference default
    use_dcn: bool = False
    use_atten: bool = True
    atten_embed_dim: int = 64                 # config.py:25
    att_layer_num: int = 3                    # config.py:26
    att_head_num: int = 2                     # config.py:27
    att_res: bool = True                      # config.py:28

    # dcn & dcnv2 (config.py:31)
    n_cross_layers: int = 3
    dcnv2_structure: str = "parallel"         # dcnv2.py:27
    dcnv2_low_rank: int = 32                  # dcnv2.py:27
    dcnv2_num_experts: int = 4                # dcnv2.py:27
    dcnv2_use_low_rank_mixture: bool = True

    # mmoe (config.py:34-36)
    mmoe_n_expert: int = 4
    mmoe_expert_dims: Tuple[int, ...] = (256, 128, 64)
    mmoe_tower_dims: Tuple[int, ...] = (64, 32)

    # ple (config.py:39-42)
    ple_n_expert_specific: int = 2
    ple_n_expert_shared: int = 2
    ple_expert_dims: Tuple[Tuple[int, ...], ...] = ((256, 128), (64,))
    ple_tower_dims: Tuple[int, ...] = (64, 32)

    # pepnet (config.py:45)
    gate_hidden_dim: int = 64

    # hinet (config.py:48)
    sei_dims: Tuple[int, ...] = (64, 32)
    sei_expert_num: int = 4                   # hinet.py:9

    # adl (config.py:52).  The reference's dlm_iters loop (adl.py:69-75)
    # recomputes identical values every iteration, so the knob is
    # intentionally NOT carried (see models/adl.py module docstring).
    dlm_update_rate: float = 0.9              # adl.py:22

    # zoo extensions BEYOND the reference (models the reference's layer
    # library supports but never wires up, layer.py:446-582): xDeepFM CIN,
    # PNN inner/outer product, AFM attention pooling
    cin_layer_sizes: Tuple[int, ...] = (128, 128)
    cin_split_half: bool = True
    pnn_kernel_type: str = "mat"              # opnn kernel: mat|vec|num
    afm_attn_size: int = 16
    afm_dropouts: Tuple[float, float] = (0.2, 0.2)

    # adasparse (adasparse.py:44-46)
    adasparse_alpha: float = 1.0
    adasparse_beta: float = 2.0
    adasparse_epsilon: float = 0.25
    adasparse_init_std: float = 1e-4          # adasparse.py:18

    # regularization (main.py:23,52-54)
    l2_reg: float = 1e-5
    l1_reg: float = 0.0

    # Reproduce the reference's PPNet weight sharing across towers
    # (pepnet.py:161,166 uses [module]*n_tower — the same module object is
    # repeated, so all towers share one set of tower-layer weights).
    pepnet_share_tower_weights: bool = True

    @property
    def l2_reg_embedding(self) -> float:
        return self.l2_reg

    @property
    def l2_reg_linear(self) -> float:
        return self.l2_reg

    @property
    def l2_reg_dnn(self) -> float:
        return self.l2_reg

    @property
    def l2_reg_cross(self) -> float:
        return self.l2_reg


@dataclass(frozen=True)
class CDCConfig:
    """CDC training-procedure hyperparameters (main.py:31-40, config.py:51-57)."""

    base_model: str = "ple"                   # main.py:18
    n_cluster: int = 4                        # main.py:31
    n_causal_mask: int = 50                   # main.py:37
    use_metric: str = "loss"                  # config.py:52
    warmup_step: int = 200                    # main.py:33 (units of 1024 rows)
    update_matrix_step: int = 2               # main.py:32 (units of 1024 rows)
    update_interval: int = 1000               # main.py:38 (units of 1024 rows)
    p_weight: float = 0.02                    # main.py:34
    p_weight_method: str = "exponential_decay"  # main.py:35
    p_weight_exp_decay: float = 0.4           # main.py:36
    affinity_func: str = "minus"              # main.py:39
    old_matrix_weight: float = 0.0            # main.py:40
    cdc_tower_dims: Tuple[int, ...] = (64, 32)  # config.py:57
    cluster_mode: str = "iterative"           # cdc.py:121
    # max number of domains concatenated into one optimization step when
    # training on a domain subset (run.py:535 hard-codes chunks of 7)
    group_chunk_size: int = 7
    save_matrix_artifacts: bool = False
    # where the training split lives during CDC (reference: whole dataset
    # on the one GPU, run.py:239,273):
    #   'resident' — dataset device-resident, steps gather rows by index
    #                (fastest; replicated per chip on a mesh)
    #   'stream'   — dataset stays in HOST memory; each dispatch ships a
    #                fixed-shape window of exactly the scheduled rows
    #                (datasets bigger than HBM, and the non-replicated
    #                placement for meshes)
    #   'auto'     — resident while the split fits the HBM budget
    #                (CDCTrainer.RESIDENT_BUDGET single-chip,
    #                MESH_RESIDENT_BUDGET per chip on a mesh), else stream
    data_placement: str = "auto"
    # ---- cdc-plus extensions (defaults = exact reference behavior).
    # The reference's counterfactual probe evaluates each domain's loss
    # response on ONE bs-sized batch after update_matrix_step (=2) train
    # steps; at small per-domain data that single-batch eval noise
    # dominates the probe signal and the recovered clustering is ~random
    # (measured: ARI 0.01-0.3 on ground-truth-clustered synthetic data,
    # docs/RESULTS.md "conflict ablation").  Three opt-in levers:
    # probe evals average over this many batches per domain (noise /sqrt E)
    probe_eval_batches: int = 1
    # EMA weight for matrix_mask across updates (the reference EMAs A/B
    # via old_matrix_weight but rebuilds mask from scratch every update,
    # cdc.py:131-134); 0 = reference behavior
    mask_ema: float = 0.0
    # stop re-clustering (and stop paying probe/rollback bursts) after
    # this many matrix updates — kills assignment churn once the
    # clustering has converged; 0 = never freeze (reference behavior)
    freeze_after_updates: int = 0
    # matrix-population row parallelism: 0 (reference-faithful) runs the
    # counterfactual rows serially with Adam moments CARRIED across rows
    # (the reference's snapshot asymmetry, cdc.py:343-351 — itself an
    # accident: save/load_model_state snapshots only the base model, never
    # the optimizer).  N>0 runs rows in lane-stacked chunks of N, each row
    # bursting independently from the update-entry snapshot with its OWN
    # moment copy (DOCUMENTED DIVERGENCE: per-row moments instead of
    # cross-row carry; row results become order-independent).
    # STATUS (round-5, measured): EXPERIMENTAL, serial default stays
    # faster at reference Ali-CCP scale — each lane needs its own
    # full-table Adam decay sweep per step (exact dense-Adam semantics),
    # so the dominant HBM term scales with N instead of amortizing, and
    # stacked lanes cannot lax.cond-skip padded burst steps.  Best
    # measured 4-lane chunk = 1.55x serial wall per row at 50 domains /
    # 1.6M rows x 16 after flat-carry + scatter-add layout fixes
    # (docs/RESULTS.md round-5; scripts/profile_populate_modes.py).
    # HBM cost is N concurrent copies of params+moments.
    parallel_rows: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Optimization/harness hyperparameters (config.py:9-15, main.py:21-25, run.py:720-723)."""

    lr: float = 1e-3                          # main.py:22
    bs: int = 512                             # config.py:13
    epoch: int = 10                           # config.py:14
    wd: float = 1e-8                          # config.py:15 (Adam weight_decay)
    adam_b1: float = 0.9                      # run.py:721
    adam_b2: float = 0.99                     # run.py:721
    adam_eps: float = 1e-8                    # run.py:721
    early_stop: int = 2                       # config.py:9
    seed: int = 2000                          # main.py:19
    is_evaluate_multi_domain: bool = True     # config.py:11
    # eval via on-device per-domain AUC histograms instead of gathering
    # every prediction to host (Trainer.evaluate_streaming; AUC error
    # O(1/8192) — the scalable choice on a mesh / for huge eval splits).
    # None = auto: streaming when running on a mesh, exact otherwise.
    eval_streaming: Optional[bool] = None
    log_interval_rows: int = 204800           # run.py:474 (log every N rows)
    save_path: str = "save"
    # operand dtype of dense contractions ('float32' or 'bfloat16').
    # bf16 feeds the MXU at its native rate (~4x f32 on v5e); every
    # contraction still ACCUMULATES and emits f32, and params, optimizer
    # state, BatchNorm stats, softmax and all elementwise math stay f32
    # (tpurec.nn.precision).  A DOCUMENTED DIVERGENCE from the
    # reference's all-f32 torch math when enabled.
    compute_dtype: str = "float32"
    # train steps fused into one scanned device dispatch (amortizes the
    # ~0.4ms per-dispatch latency that dominates sub-ms CTR steps); 1
    # disables scanning.  Round-5 sweep on the real chip:
    # 275.4k/278.9k/280.9k/282.3k/282.9k ex/s at K=64/128/256/512/1024 —
    # the curve knees at ~512 and the loss fetch is off the critical path
    # (losses sum on device per span; logging fires every K steps, close
    # to the 400-step log_interval default).  The device-resident epoch
    # path batches into long scans independently of this setting.
    steps_per_dispatch: int = 512
    # 'hybrid' (default): exact dense-Adam semantics via the small/big
    #   field split (tpurec.train.hybrid) — small-vocab fields' grads
    #   reduce to per-slice matmuls, big-field rows get two-phase exact
    #   correction; ~40% less step time than 'dense' at Ali-CCP scale
    # 'dense': exact reference Adam semantics via autodiff through the
    #   fused lookup (materializes a [V, D] gradient each step)
    # 'sparse': row-sparse lazy Adam on touched rows only (tpurec.train.
    #   sparse) — cheapest at very large vocabs, lazy-Adam semantics
    embedding_update: str = "hybrid"
    # dtype of the embedding table's Adam moment tensors ('float32' or
    # 'bfloat16').  bf16 halves the m/v HBM traffic of the dense sweep
    # (~8% faster steps at Ali-CCP scale); a DOCUMENTED DIVERGENCE from
    # the reference's f32 torch-Adam state (moment values round to bf16
    # between steps; Adam math still runs in f32)
    embedding_moments_dtype: str = "float32"
    # 'pickle' (single-file, sync) or 'orbax' (versioned dirs, async array
    # writes, multi-host-safe) for Trainer.make_checkpointer
    checkpoint_backend: str = "pickle"


@dataclass(frozen=True)
class MeshConfig:
    """SPMD mesh layout: data axis x model axis over ICI.

    The reference is single-GPU (run.py:32-33); this is the new-build
    distributed layer (SURVEY.md §2.7): batch sharded over ``data``,
    embedding-table rows sharded over ``model``.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    n_data: int = 1
    n_model: int = 1
    # shard MoE expert banks' leading axis over the model axis
    # (expert parallelism for MMoE/PLE/HiNet weight banks, SURVEY.md §2.7)
    expert_parallel: bool = False


# Static domain->group strategies (config.py:59-71).
DOMAIN2GROUP_ORG_DICT: Dict[str, Dict[str, List[int]]] = {
    "amazon": {"mix": [0] * 25, "split": list(range(25))},
    "aliccp": {"mix": [0] * 50, "split": list(range(50))},
}


@dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "synthetic"
    data_path: str = "dataset"
    n_domain: int = 6
    # synthetic-data knobs
    n_rows: int = 20000
    n_fields: int = 8
    field_dims: Optional[Tuple[int, ...]] = None
    domain_idx: int = 3                       # 'domain' position (run.py:51 amazon)
    group_strategy: str = "mix"               # main.py:27
    prepare2train_month: int = 12             # main.py:26
    domain_filter: Optional[Tuple[int, ...]] = None
    # feature hashing applied on the load path: ((field_idx, n_buckets), ...)
    # — carried in checkpoints so serving hashes raw ids identically
    # (tpurec.data.hashing; salt = field index)
    hash_buckets: Optional[Tuple[Tuple[int, int], ...]] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    cdc: CDCConfig = field(default_factory=CDCConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config(**overrides) -> Config:
    cfg = Config()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def config_to_dict(cfg: Config) -> Dict:
    """Config -> plain nested dict (for checkpoint payloads)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict) -> Config:
    """Inverse of :func:`config_to_dict`.

    Unknown keys are ignored (forward compatibility: loading an old
    checkpoint into a newer build with extra fields keeps defaults);
    list values are re-tupled to match the frozen dataclass field types.
    """
    def build(cls, sub):
        names = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for key, val in (sub or {}).items():
            if key not in names:
                continue
            if isinstance(val, list):
                val = tuple(tuple(v) if isinstance(v, list) else v
                            for v in val)
            kw[key] = val
        return cls(**kw)

    return Config(
        model=build(ModelConfig, d.get("model")),
        cdc=build(CDCConfig, d.get("cdc")),
        train=build(TrainConfig, d.get("train")),
        mesh=build(MeshConfig, d.get("mesh")),
        data=build(DataConfig, d.get("data")),
    )
