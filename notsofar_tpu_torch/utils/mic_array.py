"""NOTSOFAR multichannel device geometry.

Copy of notsofar_tpu/utils/mic_array.py: a 7-mic circular array, one
center mic plus 6 mics at radius 4.25 cm, 60 degrees apart.
"""
import numpy as np

NUM_MICS = 7
RADIUS_CM = 4.25


def multichannel_mic_pos_xyz_cm() -> np.ndarray:
    """Returns (7, 3) mic positions in cm; row 0 is the center microphone."""
    pos = np.zeros((NUM_MICS, 3), dtype=np.float64)
    angles_deg = 60.0 * np.arange(6)
    pos[1:, 0] = RADIUS_CM * np.cos(np.deg2rad(angles_deg))
    pos[1:, 1] = RADIUS_CM * np.sin(np.deg2rad(angles_deg))
    return pos
