"""Training configuration (YAML-compatible with the reference).

Copy of the config dataclasses of notsofar_tpu/training/config.py that
loading a CSS model needs: TrainCfg and its mutable *CfgM members, which
freeze into the port's model configs. The shipped YAMLs under
configs/train_css/ and the JAX package's checkpoints parse unchanged. The
training code itself comes with the training slice.
"""
from dataclasses import dataclass, field
from typing import Optional, Tuple

from notsofar_tpu_torch.models.conformer import ConformerConfig
from notsofar_tpu_torch.models.css_wrapper import (ConformerCssConfig,
                                                   NnetConfig)
from notsofar_tpu_torch.ops.features import ExtractorConfig


@dataclass
class SimulatedDatasetCfg:
    sample_frac: float = 1.0
    max_urls: Optional[int] = None


@dataclass
class SchedulerStepLrCfg:
    step_size: int = 1
    gamma: float = 1.0


@dataclass
class LinearWarmupDecayCfg:
    """Defaults per the CSS with Conformer paper (schedulers.py:6-10)."""
    warmup: int = 10000
    decay: int = 260000


# Mutable mirrors of the frozen model config dataclasses (the YAML loader
# needs to write into them; they convert to the frozen forms on demand).
@dataclass
class ExtractorCfgM:
    ang_index: str = ""
    frame_hop: int = 256
    frame_len: int = 512
    ipd_cos: bool = False
    ipd_index: str = "1,0;2,0;3,0;4,0;5,0;6,0"
    ipd_mean_normalize: bool = True
    ipd_mean_normalize_version: int = 1
    log_spectrogram: bool = False
    mvn_spectrogram: bool = True
    num_spks: int = 2
    round_pow_of_two: bool = True
    window: str = "hann"

    def freeze(self) -> ExtractorConfig:
        return ExtractorConfig(
            ang_index=self.ang_index, frame_hop=self.frame_hop,
            frame_len=self.frame_len, ipd_cos=self.ipd_cos,
            ipd_index=self.ipd_index,
            ipd_mean_normalize=self.ipd_mean_normalize,
            ipd_mean_normalize_version=self.ipd_mean_normalize_version,
            log_spectrogram=self.log_spectrogram,
            mvn_spectrogram=self.mvn_spectrogram, num_spks=self.num_spks,
            round_pow_of_two=self.round_pow_of_two, window=self.window)


@dataclass
class ConformerCfgM:
    attention_dim: int = 256
    attention_heads: int = 4
    dropout_rate: float = 0.1
    kernel_size: int = 33
    linear_units: int = 1024
    num_blocks: int = 16

    def freeze(self) -> ConformerConfig:
        return ConformerConfig(
            attention_dim=self.attention_dim,
            attention_heads=self.attention_heads,
            dropout_rate=self.dropout_rate, kernel_size=self.kernel_size,
            linear_units=self.linear_units, num_blocks=self.num_blocks)


@dataclass
class NnetCfgM:
    conformer_conf: ConformerCfgM = field(default_factory=ConformerCfgM)
    in_features: int = 1799
    num_nois: int = 1
    num_spks: int = 3

    def freeze(self) -> NnetConfig:
        return NnetConfig(conformer_conf=self.conformer_conf.freeze(),
                          in_features=self.in_features,
                          num_nois=self.num_nois, num_spks=self.num_spks)


@dataclass
class ConformerCssCfgM:
    extractor_conf: ExtractorCfgM = field(default_factory=ExtractorCfgM)
    nnet_conf: NnetCfgM = field(default_factory=NnetCfgM)

    def freeze(self) -> ConformerCssConfig:
        return ConformerCssConfig(extractor_conf=self.extractor_conf.freeze(),
                                  nnet_conf=self.nnet_conf.freeze())


@dataclass
class TrainCfg:
    """Mirror of TrainCfg (the reference train.py) with the JAX package's
    additions at the bottom."""
    train_dir: str = ""
    val_dir: str = ""
    out_dir: str = ""

    train_set_cfg: SimulatedDatasetCfg = field(default_factory=SimulatedDatasetCfg)
    val_set_cfg: SimulatedDatasetCfg = field(default_factory=SimulatedDatasetCfg)

    single_channel: bool = False

    segment_len_secs: float = 3.0
    fs: int = 16000
    segment_min_overlap_factor: float = 1 / 6
    segment_max_overlap_factor: float = 1 / 2
    segment_pr_force_align: float = 0.5

    learning_rate: float = 1e-3
    global_batch_size: int = 32
    clip_grad_norm: float = 0.01
    clip_gt_to_mixture: bool = False
    weight_decay: float = 1e-4
    noise_weight: float = 1.0
    calc_side_info: bool = False
    base_loss_name: str = "mse"     # {'mse', 'l1'}
    loss_name: str = "masked_mag"   # {'masked_mag', 'mask'}
    is_debug: bool = False
    log_params_mlflow: bool = True
    log_metrics_mlflow: bool = True
    seed: int = 59438191
    dataloader_workers: int = 8

    model_name: str = "css_with_conformer"
    conformer_css_cfg: ConformerCssCfgM = field(default_factory=ConformerCssCfgM)

    scheduler_name: str = "step_lr"  # {'step_lr', 'linear_warmup_decay'}
    scheduler_step_lr_cfg: SchedulerStepLrCfg = field(default_factory=SchedulerStepLrCfg)
    scheduler_linear_warmup_decay_cfg: LinearWarmupDecayCfg = field(
        default_factory=LinearWarmupDecayCfg)

    eval_every: Optional[Tuple] = (1, "epochs")
    save_every: Optional[Tuple] = None
    scheduler_step_every: Optional[Tuple] = (1, "epochs")
    stop_after: Optional[Tuple] = (120, "epochs")

    # --- the JAX package's additions ---
    dtype: str = "float32"           # compute dtype for the model
    data_axis: str = "dp"            # mesh axis name for data parallelism
    checkpoint_keep: int = 3         # orbax checkpoints retained
