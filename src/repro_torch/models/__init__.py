"""The LM substrate, dense family (counterpart of ``src/repro/models/``)."""
