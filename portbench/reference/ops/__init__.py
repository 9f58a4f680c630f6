"""Signal ops (counterpart of ddsp_piano_tpu/ops): core, oscillator,
filters and fdn."""
