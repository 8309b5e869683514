"""Encoder families of the plain reference, one file each, named by a
configuration's ``model.kind`` (see ``encoders.py``)."""
