"""CSS training CLI of the PyTorch/CUDA port.

The same flags as run_training_css_local.py: loads a TrainCfg yaml
(configs/train_css/debug_mc.yaml by default) and runs the trainer on a
CUDA card:

    python run_training_css_gpu.py --conf configs/train_css/conformer_v1.0_mc.yaml \
        --data_root_in <root> --data_root_out <out> [--resume]
    torchrun --nproc_per_node 4 run_training_css_gpu.py --conf ...

Under torchrun every process trains on its shard of each global batch (one
card per process, NCCL). --device cpu runs the plain PyTorch path (gloo
under torchrun); without it the run needs a card and raises if there is
none.
"""
import argparse
import os
import shutil
from pathlib import Path

from notsofar_tpu_torch.parallel.mesh import maybe_initialize_distributed
from notsofar_tpu_torch.training.config import TrainCfg
from notsofar_tpu_torch.training.train import run_training_css
from notsofar_tpu_torch.utils.conf import load_yaml_to_dataclass
from notsofar_tpu_torch.utils.device import resolve_device
from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("run_training")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", default=None)
    parser.add_argument("--data_root_in", default=None)
    parser.add_argument("--data_root_out", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in out_dir")
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    maybe_initialize_distributed(device)

    project_dir = Path(__file__).parent
    conf_path = str(project_dir / "configs" / "train_css" / "debug_mc.yaml") \
        if args.conf is None else args.conf
    data_root_in = project_dir if args.data_root_in is None \
        else Path(args.data_root_in)
    data_root_out = project_dir / "artifacts" / "outputs" / "css_train" \
        if args.data_root_out is None else Path(args.data_root_out)

    train_cfg = load_yaml_to_dataclass(conf_path, TrainCfg)
    train_dir = data_root_in / train_cfg.train_dir
    val_dir = data_root_in / train_cfg.val_dir
    out_dir = data_root_out / train_cfg.out_dir

    _LOG.info(f"Copying the config to {out_dir}")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(conf_path, str(Path(out_dir) / "config.yaml"))

    return run_training_css(train_cfg, train_dir=str(train_dir),
                            val_dir=str(val_dir), out_dir=str(out_dir),
                            resume=args.resume, device=device)


if __name__ == "__main__":
    main()
