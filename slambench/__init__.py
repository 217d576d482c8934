"""The benchmark of ar_orbslam2_tpu_torch on one NVIDIA H100: see
README.md. Importing this package loads nothing of the program."""
