"""Build the CUDA sweep library: ``python -m trialign.cuda``."""

from trialign.cuda import build

print(build())
