"""Performance attribution: the port keeps only the serving host/device
split (:mod:`.phases`) of ``dlrover_tpu/attribution/``."""
