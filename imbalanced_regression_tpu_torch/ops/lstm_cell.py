"""The LSTM cell of the STS-B BiLSTM, one time step, in plain PyTorch: the
plain versions of the CUDA cell kernels (``csrc/lstm_cell.cu``,
:func:`ops.cuda_kernels.lstm_cell_forward` / ``lstm_cell_backward``), which
the wrappers run for CPU tensors.

Both write into the layer's buffers in place, step ``t`` of ``steps``:
``xw``, ``gates`` and ``dg`` are [rows, steps, 4H] in the module type T
(float32 or bf16; float64 for gradient checks); ``c_all``, ``hs`` and
``dhs`` [rows, steps, H] in the state type (float32, float64 with a
float64 T); ``hprev`` [rows, steps, H] in T holds at ``[:, t]`` the state
``h_{t-1}`` that step ``t`` multiplies by the recurrent kernel. The gate
order is i, f, g, o. The forward runs the ATen operations of
``models.bilstm_pair.exported_recurrence`` in its order, so the two give
the same bits."""

from __future__ import annotations

import torch


def lstm_cell_forward_plain(xw, hw, c_all, hs, hprev, gates, t: int) -> None:
    """Gates ``xw[:, t] + hw`` summed in T (``hw`` unused at ``t = 0``,
    where ``h_{-1} = 0``), saved into ``gates[:, t]`` unless it is None,
    then in the state type ``c = sigmoid(f) * c_{t-1} + sigmoid(i) *
    tanh(g)`` (``c_{-1} = 0``) and ``h = sigmoid(o) * tanh(c)`` into
    ``c_all[:, t]`` and ``hs[:, t]``; ``h`` in T into ``hprev[:, t + 1]``,
    and zeros into ``hprev[:, 0]`` at ``t = 0``."""
    pre = xw[:, t] if t == 0 else xw[:, t] + hw
    if gates is not None:
        gates[:, t] = pre
    i, f, g, o = pre.to(hs.dtype).chunk(4, dim=-1)
    ig = torch.sigmoid(i) * torch.tanh(g)
    c = ig if t == 0 else torch.sigmoid(f) * c_all[:, t - 1] + ig
    h = torch.sigmoid(o) * torch.tanh(c)
    c_all[:, t] = c
    hs[:, t] = h
    if t + 1 < hs.shape[1]:
        hprev[:, t + 1] = h
    if t == 0:
        hprev[:, 0] = 0


def lstm_cell_backward_plain(gates, c_all, dhs, dh_rec, dc, dg, t: int) -> None:
    """The gradient of step ``t``'s cell: with ``dh = dhs[:, t] + dh_rec``
    and ``dc_{t+1}`` from ``dc`` (both only for ``t < steps - 1``), write
    the gate pre-activations' gradient into ``dg[:, t]`` (T) and
    ``dc_t = (dc_{t+1} + dh * o * (1 - tanh(c)^2)) * f`` into ``dc``; the
    nonlinearities recomputed from the saved ``gates``."""
    last = t == gates.shape[1] - 1
    a_i, a_f, a_g, a_o = gates[:, t].to(dc.dtype).chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(a_i), torch.sigmoid(a_f), torch.tanh(a_g), torch.sigmoid(a_o)
    c = c_all[:, t]
    cp = c_all[:, t - 1] if t else torch.zeros_like(c)
    tc = torch.tanh(c)
    dh = dhs[:, t] if last else dhs[:, t] + dh_rec.to(dc.dtype)
    dcu = dh * o * (1.0 - tc * tc)
    if not last:
        dcu = dc + dcu
    dg[:, t] = torch.cat([dcu * g * i * (1.0 - i), dcu * cp * f * (1.0 - f),
                          dcu * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
    dc.copy_(dcu * f)
