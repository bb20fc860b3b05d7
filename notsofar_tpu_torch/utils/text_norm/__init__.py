"""Text normalization for scoring (CHiME-8 aligned).

Copy of notsofar_tpu/utils/text_norm/__init__.py (framework-free; the
port keeps its own copy).
"""
from notsofar_tpu_torch.utils.text_norm.basic import BasicTextNormalizer
from notsofar_tpu_torch.utils.text_norm.english import EnglishTextNormalizer


def get_txt_norm(txt_norm):
    assert txt_norm in ("chime8", None)
    if txt_norm is None:
        return None
    if txt_norm == "chime8":
        return EnglishTextNormalizer()
    raise NotImplementedError(txt_norm)
