"""Recurrent layers (port of ``paddle_tpu/nn/rnn.py``).

The three sequence ops ``lstm_seq``, ``gru_seq`` and ``rnn_seq`` run one
layer in one direction over a time-major sequence; they are registered
into the op registry here, outside ``ops.yaml``, as in the JAX package.
Each is one call of torch's fused recurrence (``torch._VF.lstm`` /
``gru`` / ``rnn_tanh`` / ``rnn_relu``: cuDNN on the card), which keeps the
JAX package's gate order and formulas: LSTM gates i, f, g, o; GRU gates
r, z, n with n = tanh(x W_in + b_in + r (h W_hn + b_hn)) and
h' = (1 - z) n + z h. The time loop never reads the host.

``SimpleRNN``, ``GRU`` and ``LSTM`` stack them by ``num_layers`` and
``direction`` (the reverse direction runs the flipped sequence), with
dropout between layers; the cells and ``RNN`` step one cell in Python.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops import registry as _registry
from paddle_tpu_torch.ops.registry import register_emitter as op_emitter

__all__ = ["SimpleRNN", "LSTM", "GRU", "SimpleRNNCell", "LSTMCell", "GRUCell",
           "RNN"]


# ---- the sequence ops, registered outside the manifest ---------------------
def _train():
    """cuDNN keeps what its backward needs only in training mode; the
    recurrences have no dropout, so the flag changes nothing else."""
    return torch.is_grad_enabled()


@op_emitter
def lstm_seq(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
    """x [T, B, I] -> (out [T, B, H], h_n, c_n)."""
    out, hn, cn = torch._VF.lstm(x, (h0[None], c0[None]),
                                 [w_ih, w_hh, b_ih, b_hh], True, 1, 0.0,
                                 _train(), False, False)
    return out, hn[0], cn[0]


@op_emitter
def gru_seq(x, w_ih, w_hh, b_ih, b_hh, h0):
    out, hn = torch._VF.gru(x, h0[None], [w_ih, w_hh, b_ih, b_hh], True, 1,
                            0.0, _train(), False, False)
    return out, hn[0]


@op_emitter
def rnn_seq(x, w_ih, w_hh, b_ih, b_hh, h0, activation="tanh"):
    fn = torch._VF.rnn_tanh if activation == "tanh" else torch._VF.rnn_relu
    out, hn = fn(x, h0[None], [w_ih, w_hh, b_ih, b_hh], True, 1, 0.0,
                 _train(), False, False)
    return out, hn[0]


for _name, _targs in [("lstm_seq", ["x", "w_ih", "w_hh", "b_ih", "b_hh",
                                    "h0", "c0"]),
                      ("gru_seq", ["x", "w_ih", "w_hh", "b_ih", "b_hh",
                                   "h0"]),
                      ("rnn_seq", ["x", "w_ih", "w_hh", "b_ih", "b_hh",
                                   "h0"])]:
    _registry.build_registry([{"op": _name, "tensor_args": _targs,
                               "methods": []}])


def _seq_op(name):
    return _registry.API[name]


class _RNNBase(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        ndir = 2 if self.bidirect else 1
        self.num_directions = ndir
        k = 1.0 / (hidden_size ** 0.5)
        u = init.Uniform(-k, k)
        g = self.GATES
        for layer in range(num_layers):
            for d in range(ndir):
                isz = input_size if layer == 0 else hidden_size * ndir
                sfx = f"{layer}" + ("_reverse" if d else "")
                self.add_parameter(
                    f"weight_ih_l{sfx}",
                    self.create_parameter([g * hidden_size, isz],
                                          default_initializer=u))
                self.add_parameter(
                    f"weight_hh_l{sfx}",
                    self.create_parameter([g * hidden_size, hidden_size],
                                          default_initializer=u))
                self.add_parameter(
                    f"bias_ih_l{sfx}",
                    self.create_parameter([g * hidden_size],
                                          default_initializer=u))
                self.add_parameter(
                    f"bias_hh_l{sfx}",
                    self.create_parameter([g * hidden_size],
                                          default_initializer=u))

    def _params(self, layer, reverse):
        sfx = f"{layer}" + ("_reverse" if reverse else "")
        return (self._parameters[f"weight_ih_l{sfx}"],
                self._parameters[f"weight_hh_l{sfx}"],
                self._parameters[f"bias_ih_l{sfx}"],
                self._parameters[f"bias_hh_l{sfx}"])

    def forward(self, inputs, initial_states=None):
        x = inputs
        if not self.time_major:
            x = ops.transpose(x, [1, 0, 2])      # -> [T, B, I]
        B = x.shape[1]
        ndir = self.num_directions
        L = self.num_layers
        states = self._init_states(initial_states, B, x)
        final_states = []
        out = x
        for layer in range(L):
            outs_dir = []
            for d in range(ndir):
                seq = ops.flip(out, [0]) if d else out
                res = self._run_dir(seq, layer, d, states)
                y = res[0]
                final_states.append(res[1:])
                if d:
                    y = ops.flip(y, [0])
                outs_dir.append(y)
            out = (ops.concat(outs_dir, axis=-1) if ndir == 2
                   else outs_dir[0])
            if self.dropout > 0 and layer < L - 1:
                out = ops.dropout(out, self.dropout, training=self.training)
        if not self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        return out, self._pack_final(final_states)

    def _zeros(self, batch, like):
        return ops.zeros([self.num_layers * self.num_directions, batch,
                          self.hidden_size]).to(device=like.place)

    def _init_states(self, initial_states, batch, like):
        if initial_states is None:
            return self._zeros(batch, like)
        return initial_states

    def _run_dir(self, seq, layer, d, states):
        raise NotImplementedError

    def _pack_final(self, finals):
        return ops.stack([f[0] for f in finals], axis=0)


class SimpleRNN(_RNNBase):
    GATES = 1

    def _run_dir(self, seq, layer, d, states):
        h0 = states[layer * self.num_directions + d]
        return _seq_op("rnn_seq")(seq, *self._params(layer, d), h0,
                                  activation=self.activation)


class GRU(_RNNBase):
    GATES = 3

    def _run_dir(self, seq, layer, d, states):
        h0 = states[layer * self.num_directions + d]
        return _seq_op("gru_seq")(seq, *self._params(layer, d), h0)


class LSTM(_RNNBase):
    GATES = 4

    def _init_states(self, initial_states, batch, like):
        if initial_states is None:
            return (self._zeros(batch, like), self._zeros(batch, like))
        return initial_states

    def _run_dir(self, seq, layer, d, states):
        idx = layer * self.num_directions + d
        return _seq_op("lstm_seq")(seq, *self._params(layer, d),
                                   states[0][idx], states[1][idx])

    def _pack_final(self, finals):
        h = ops.stack([f[0] for f in finals], axis=0)
        c = ops.stack([f[1] for f in finals], axis=0)
        return (h, c)


# ---- cells -----------------------------------------------------------------
class _Cell(Layer):
    GATES = 1

    def __init__(self, input_size, hidden_size, **kw):
        super().__init__()
        k = 1.0 / (hidden_size ** 0.5)
        u = init.Uniform(-k, k)
        g = self.GATES
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([g * hidden_size, input_size],
                                               default_initializer=u)
        self.weight_hh = self.create_parameter(
            [g * hidden_size, hidden_size], default_initializer=u)
        self.bias_ih = self.create_parameter([g * hidden_size],
                                             default_initializer=u)
        self.bias_hh = self.create_parameter([g * hidden_size],
                                             default_initializer=u)

    def _zeros(self, inputs):
        return ops.zeros([inputs.shape[0], self.hidden_size]).to(
            device=inputs.place)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        pre = (ops.matmul(inputs, self.weight_ih.T)
               + ops.matmul(states, self.weight_hh.T)
               + self.bias_ih + self.bias_hh)
        h = ops.tanh(pre) if self.activation == "tanh" else ops.relu(pre)
        return h, h


class LSTMCell(_Cell):
    GATES = 4

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        h, c = states
        gates = (ops.matmul(inputs, self.weight_ih.T)
                 + ops.matmul(h, self.weight_hh.T)
                 + self.bias_ih + self.bias_hh)
        i, f, g, o = ops.split(gates, 4, axis=-1)
        i, f, o = ops.sigmoid(i), ops.sigmoid(f), ops.sigmoid(o)
        g = ops.tanh(g)
        c2 = f * c + i * g
        h2 = o * ops.tanh(c2)
        return h2, (h2, c2)


class GRUCell(_Cell):
    GATES = 3

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        gi = ops.matmul(inputs, self.weight_ih.T) + self.bias_ih
        gh = ops.matmul(states, self.weight_hh.T) + self.bias_hh
        i_r, i_z, i_n = ops.split(gi, 3, axis=-1)
        h_r, h_z, h_n = ops.split(gh, 3, axis=-1)
        r = ops.sigmoid(i_r + h_r)
        z = ops.sigmoid(i_z + h_z)
        n = ops.tanh(i_n + r * h_n)
        h2 = (1.0 - z) * n + z * states
        return h2, h2


class RNN(Layer):
    """Runs a cell over a sequence (paddle.nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        x = inputs if self.time_major else ops.transpose(inputs, [1, 0, 2])
        T = x.shape[0]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        state = initial_states
        outs = [None] * T
        for ti in steps:
            y, state = self.cell(x[ti], state)
            outs[ti] = y
        out = ops.stack(outs, axis=0)
        if not self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        return out, state
