"""The challenge scoring battery (``eval.py``) and its shipped wrapper
checkpoints (``RND2D_mcl.npz``, ``AE2D_mcl.npz``)."""
