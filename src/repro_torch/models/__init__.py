"""The LM substrate, dense and MoE families (counterpart of ``src/repro/models/``)."""
