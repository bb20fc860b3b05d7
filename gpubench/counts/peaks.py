"""Published peaks of the cards the benchmark knows (NVIDIA's H100 data
sheet, SXM part, dense rates without sparsity, at the 700 W limit).

A card that is not in the table has no peaks here: the rooflines and
utilisations read nothing on it rather than a bound of another card.
"""
from typing import Dict, Optional

# name fragment (lower case) of torch.cuda.get_device_name() -> peaks
PEAKS = {
    "h100 80gb hbm3": {"bf16": 989e12, "f32": 67e12, "tf32": 495e12,
                       "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    kind = (kind or "").lower()
    for key, p in PEAKS.items():
        if key in kind:
            return p
    return None
