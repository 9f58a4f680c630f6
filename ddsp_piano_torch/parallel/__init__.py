"""Data parallelism (counterpart of ddsp_piano_tpu/parallel): ranks,
process groups, the rank launcher and each rank's rows of a batch."""
