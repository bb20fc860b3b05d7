"""NOTSOFAR data plane: dataset/model downloads via azcopy.

Copy of notsofar_tpu/utils/azure_storage.py, the NOTSOFAR baseline's
utils/azure_storage.py (host tooling — kept native-subprocess based).
Downloads are skip-if-exists cached; azcopy is
resolved from PATH or AZCOPY_PATH, and — matching the reference's
get_azcopy_path (azure_storage.py:72-106) — self-deployed from the
NOTSOFAR assets container into artifacts/tools/azcopy when absent
(zero-egress environments mount the data instead; see `local_override` /
NOTSOFAR_DATA_ROOT).
"""
import json
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

from notsofar_tpu_torch.utils.logging_def import get_logger

_LOG = get_logger("azure_storage")

MEETING_DATA_URL = ("https://notsofarsa.blob.core.windows.net/"
                    "benchmark-datasets")
SIMULATED_DATA_URL = ("https://notsofarsa.blob.core.windows.net/"
                      "css-datasets")
MODELS_URL = "https://notsofarsa.blob.core.windows.net/css-models"

# subset_name -> {version: relative path} — the FULL published catalog
# (mirrors the versions enumerated in azure_storage.py:109-199 docstrings,
# latest first)
MEETING_SUBSETS = {
    "dev_set": {
        "240825.1_dev1": "dev_set/240825.1_dev1/MTG",
        "240415.2_dev_with_GT": "dev_set/240415.2_dev_with_GT/MTG",
        "240415.2_dev": "dev_set/240415.2_dev/MTG",
        "240208.2_dev": "dev_set/240208.2_dev/MTG",
    },
    "train_set": {
        "240825.1_train": "train_set/240825.1_train/MTG",
        "240501.1_train": "train_set/240501.1_train/MTG",
        "240415.1_train": "train_set/240415.1_train/MTG",
        "240229.1_train": "train_set/240229.1_train/MTG",
        "240208.2_train": "train_set/240208.2_train/MTG",
    },
    "eval_set": {
        "240825.1_eval_full_with_GT":
            "eval_set/240825.1_eval_full_with_GT/MTG",
        "240629.1_eval_small_with_GT":
            "eval_set/240629.1_eval_small_with_GT/MTG",
        "240629.1_eval_small": "eval_set/240629.1_eval_small/MTG",
    },
}

ASSETS_URL = "https://notsofarsa.blob.core.windows.net/assets"
_AZCOPY_FILE_NAME = {"windows": "azcopy.exe", "linux": "azcopy",
                     "darwin": "azcopy_mos"}


def get_azcopy_path() -> str:
    """PATH/AZCOPY_PATH lookup, else self-deploy the azcopy binary from
    the NOTSOFAR assets container into artifacts/tools/azcopy (reference
    get_azcopy_path semantics). Raises FileNotFoundError on failure."""
    found = _find_azcopy()
    if found:
        return found
    system = platform.system().lower()
    if system not in _AZCOPY_FILE_NAME:
        raise FileNotFoundError(
            f"no azcopy binary published for platform {system!r}")
    deploy_dir = Path(__file__).resolve().parents[2] / "artifacts" \
        / "tools" / "azcopy"
    deploy_dir.mkdir(parents=True, exist_ok=True)
    fname = _AZCOPY_FILE_NAME[system]
    dst = deploy_dir / fname
    if not dst.is_file():
        _LOG.info(f"azcopy not found; deploying to {dst}")
        # Download to a temp path and move into place only on success —
        # an HTTP error (-f makes curl fail on 4xx/5xx) or an interrupted
        # transfer must not leave a partial file that _find_azcopy() would
        # treat as a valid deploy forever after.
        tmp = dst.with_suffix(".tmp")
        try:
            subprocess.run(["curl", "-fL", f"{ASSETS_URL}/azcopy/{fname}",
                            "-o", str(tmp)], check=True)
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            raise FileNotFoundError(
                f"failed to deploy azcopy to {dst} (curl rc={e.returncode})")
        if not tmp.is_file() or tmp.stat().st_size == 0:
            tmp.unlink(missing_ok=True)
            raise FileNotFoundError(f"failed to deploy azcopy to {dst}")
        if system != "windows":
            tmp.chmod(0o755)
        os.replace(tmp, dst)
    return str(dst)


def _find_azcopy() -> Optional[str]:
    env = os.environ.get("AZCOPY_PATH")
    if env:
        return env
    on_path = shutil.which("azcopy")
    if on_path:
        return on_path
    fname = _AZCOPY_FILE_NAME.get(platform.system().lower())
    if fname is None:
        return None
    deployed = Path(__file__).resolve().parents[2] / "artifacts" / "tools" \
        / "azcopy" / fname
    return str(deployed) if deployed.is_file() else None


def _azcopy(src_url: str, dst: Path) -> bool:
    try:
        azcopy = get_azcopy_path()
    except (FileNotFoundError, OSError) as e:
        _LOG.warning(f"azcopy unavailable ({e}); cannot download. Set "
                     "AZCOPY_PATH, or mount the data locally and set "
                     "NOTSOFAR_DATA_ROOT.")
        return False
    t0 = time.time()
    res = subprocess.run([azcopy, "copy", src_url, str(dst), "--recursive",
                          "--overwrite", "ifSourceNewer"],
                         capture_output=True, text=True)
    _LOG.info(f"azcopy finished in {time.time() - t0:.1f}s "
              f"(rc={res.returncode})")
    if res.returncode != 0:
        _LOG.error(res.stderr[-2000:])
    return res.returncode == 0


def _local_root() -> Optional[Path]:
    root = os.environ.get("NOTSOFAR_DATA_ROOT")
    return Path(root) if root else None


def download_meeting_subset(subset_name: str, version: str,
                            destination_dir: str) -> Optional[str]:
    """Fetch a meeting subset; returns the local MTG directory.

    Skip-if-exists caching like the reference (azure_storage.py:43-45).
    """
    rel = MEETING_SUBSETS.get(subset_name, {}).get(version)
    if rel is None:
        rel = f"{subset_name}/{version}/MTG"
    dest = Path(destination_dir) / subset_name / version / "MTG"
    if dest.exists() and any(dest.iterdir()):
        _LOG.info(f"meeting subset already present: {dest}")
        return str(dest)
    local = _local_root()
    if local is not None and (local / rel).exists():
        _LOG.info(f"using locally mounted data: {local / rel}")
        return str(local / rel)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if _azcopy(f"{MEETING_DATA_URL}/{rel}", dest.parent):
        return str(dest)
    return None


def download_simulated_subset(version: str, volume: str, subset_name: str,
                              destination_dir: str) -> Optional[str]:
    """Fetch a simulated CSS training subset (200hrs/1000hrs)."""
    rel = f"{version}/{volume}/{subset_name}"
    dest = Path(destination_dir) / rel
    if dest.exists() and any(dest.iterdir()):
        return str(dest)
    local = _local_root()
    if local is not None and (local / "css" / rel).exists():
        return str(local / "css" / rel)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if _azcopy(f"{SIMULATED_DATA_URL}/{rel}", dest.parent):
        return str(dest)
    return None


def download_models(destination_dir: str, pattern: Optional[str] = None
                    ) -> Optional[str]:
    """Fetch the shipped CSS model checkpoints."""
    dest = Path(destination_dir)
    marker = dest / "notsofar"
    if marker.exists():
        _LOG.info(f"models already present: {dest}")
        return str(dest)
    local = _local_root()
    if local is not None and (local / "css_models").exists():
        return str(local / "css_models")
    dest.mkdir(parents=True, exist_ok=True)
    url = f"{MODELS_URL}/*" if pattern is None else f"{MODELS_URL}/{pattern}"
    if _azcopy(url, dest):
        return str(dest)
    return None
