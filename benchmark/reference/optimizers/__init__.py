"""Optimizers of the plain reference, one file each, named by a
configuration's ``optimizer.name`` lowercased (see ``train.py``)."""
