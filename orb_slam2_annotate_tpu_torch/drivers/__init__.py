"""The dataset drivers (ports of examples/run_*.py), each run as a module:

    python -m orb_slam2_annotate_tpu_torch.drivers.run_tum mono <settings.yaml> <sequence_dir>
    python -m orb_slam2_annotate_tpu_torch.drivers.run_kitti mono <settings.yaml> <sequence_dir>
    python -m orb_slam2_annotate_tpu_torch.drivers.run_euroc stereo <settings.yaml> <mav0_dir> <timestamps.txt>
    python -m orb_slam2_annotate_tpu_torch.drivers.run_synthetic [n_frames] [--free]

Each takes the arguments of its example plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain twins on the CPU).
"""
