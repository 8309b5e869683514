"""The general generators of the benchmark's kinds of traffic, one module
each, named by a traffic file's ``loop``."""
