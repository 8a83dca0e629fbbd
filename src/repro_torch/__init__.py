"""PyTorch/CUDA port of the serving system (see README.md, "The PyTorch port").

Imports ``torch`` and nothing of the reference package; every pure-Python
module it needs is a copy kept here.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
