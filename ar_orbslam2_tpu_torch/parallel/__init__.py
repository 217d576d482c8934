"""Multi-process execution on torch.distributed: landmark-sharded
distributed BA, one rank per process (port of ar_orbslam2_tpu/parallel)."""
