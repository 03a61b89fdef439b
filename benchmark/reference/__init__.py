"""The plain reference that decides ``correct``: the DIR training recipe
(Yang et al., ICML 2021) written out in plain PyTorch and NumPy/SciPy,
float32 with TF32 off.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands both sides the same raw inputs (weights drawn
from the seed, images, tokens, labels, the seeds of the random draws), and
the reference works out again everything the program derives from them
(LDS weights, bucket indices, FDS statistics, augmentation, dropout).

- :mod:`reference.fds`: LDS weights, FDS statistics, smoothing and
  calibration;
- :mod:`reference.resnet`: the ResNet-50 regression network;
- :mod:`reference.bilstm`: the GloVe + fused BiLSTM sentence-pair network;
- :mod:`reference.optim`: losses, Adam, the global-norm clip and the
  lower-precision operand rounding of the control.
"""
