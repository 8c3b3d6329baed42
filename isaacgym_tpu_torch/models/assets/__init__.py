"""URDF assets of the flagship scene, copied from the JAX package."""

import os

ASSET_DIR = os.path.dirname(os.path.abspath(__file__))
