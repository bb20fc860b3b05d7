"""Inference CLI of the PyTorch/CUDA port: the full meeting-transcription
pipeline (CSS -> ASR -> diarization -> tcpWER / tcORC-WER) on a CUDA card.

The same config scenarios as run_inference.py:

    python run_inference_gpu.py --config-name dev_set_mc_debug
    python run_inference_gpu.py --config-name full_dev_set_mc \
        --meetings-dir <MTG dir> --models-dir <models dir>
    python run_inference_gpu.py --config-name full_dev_set_sc

--device cpu runs the plain PyTorch path (tests, debugging). The ASR
weight storage is the YAML's ``asr.compute_dtype`` ('int8' for the int8
decoder with int8 cross-attention K/V). Without --meetings-dir /
--models-dir the data are resolved as run_inference.py does (azcopy, or
NOTSOFAR_DATA_ROOT-mounted local data).
"""
import argparse
from pathlib import Path
from pprint import pprint

from notsofar_tpu_torch.inference_pipeline.inference import (
    FetchFromCacheCfg, InferenceCfg, inference_pipeline)
from notsofar_tpu_torch.utils.azure_storage import (download_meeting_subset,
                                                    download_models)
from notsofar_tpu_torch.utils.conf import load_yaml_to_dataclass


def get_project_root() -> Path:
    return Path(__file__).parent


def load_config(config_name: str) -> InferenceCfg:
    """config name -> yaml + session_query (run_inference.py's three)."""
    root = get_project_root()
    if config_name == "full_dev_set_mc":
        conf_file = root / "configs/inference/inference_v1.yaml"
        session_query = "is_mc == True"
    elif config_name == "full_dev_set_sc":
        conf_file = root / "configs/inference/inference_v1.yaml"
        session_query = "is_mc == False"
    elif config_name == "dev_set_mc_debug":
        conf_file = root / "configs/inference/debug_inference.yaml"
        session_query = ('device_name == "plaza_0" and is_mc == True and '
                         'meeting_id == "MTG_30860"')
    else:
        raise ValueError(f"unknown config name: {config_name}")

    cfg: InferenceCfg = load_yaml_to_dataclass(str(conf_file), InferenceCfg)
    if cfg.session_query is not None:
        raise ValueError("the yaml sets session_query; the config name "
                         "sets it here")
    cfg.session_query = session_query
    return cfg


def main(config_name: str, output_dir: str = "", meetings_dir: str = "",
         models_dir: str = "", device: str = "cuda"):
    root = get_project_root()
    cfg = load_config(config_name)

    if not meetings_dir:
        meetings_dir = download_meeting_subset(
            subset_name="dev_set", version="240825.1_dev1",
            destination_dir=str(root / "artifacts" / "meeting_data"))
        if meetings_dir is None:
            raise RuntimeError(
                "failed to resolve the benchmark dataset; pass "
                "--meetings-dir or set NOTSOFAR_DATA_ROOT")
    if not models_dir:
        models_dir = download_models(
            destination_dir=str(root / "artifacts" / "css_models"))
        if models_dir is None:
            raise RuntimeError("failed to resolve CSS models; pass "
                               "--models-dir or set NOTSOFAR_DATA_ROOT")

    outputs_dir = (root if output_dir == "" else Path(output_dir)) \
        / "artifacts" / "outputs"
    exp_name = ("pass_through" if cfg.css.pass_through_ch0 else "css") \
        + "_" + cfg.asr.model_name
    outputs_dir = outputs_dir / exp_name

    pprint(f"{config_name=}")
    pprint(cfg)
    return inference_pipeline(meetings_dir=str(meetings_dir),
                              models_dir=str(models_dir),
                              out_dir=str(outputs_dir), cfg=cfg,
                              cache=FetchFromCacheCfg(), device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Run the inference pipeline on a CUDA card")
    parser.add_argument("--config-name", type=str, default="dev_set_mc_debug")
    parser.add_argument("--output-dir", type=str, default="")
    parser.add_argument("--meetings-dir", type=str, default="",
                        help="local meetings dir (skips download)")
    parser.add_argument("--models-dir", type=str, default="",
                        help="local CSS/whisper models dir (skips download)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (plain PyTorch path)")
    args = parser.parse_args()
    main(args.config_name, args.output_dir, args.meetings_dir,
         args.models_dir, args.device)
