"""`version` subcommand (reference turing/main.cpp:54-162 `turing version`
/ turing.h turing_version): print the package version and the PyTorch,
CUDA and native-core backends it finds.
"""
import shutil
import subprocess
import sys


def main():
    import torch

    import turingcodec_tpu_torch
    print(f"turingcodec_tpu_torch {turingcodec_tpu_torch.__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"cuda available: {torch.cuda.is_available()}")
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()})")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print("nvcc:", out[-1] if out else "no output")
    except OSError:
        print("nvcc: not found")
    from turingcodec_tpu_torch.native import get_lib
    lib = get_lib()
    print("native core:", "loaded" if lib is not None else "unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
