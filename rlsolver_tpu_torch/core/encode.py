"""Solution bitstring <-> base64 codec (counterpart of
`rlsolver_tpu/core/encode.py`).

String-compatible with the reference's `EncoderBase64`
(`rlsolver/methods/util_evaluator.py:22-65`): the bit vector is read as a
big-endian binary integer and written in base 64 with the digit alphabet
"0-9A-Za-z_$", zero-padded to ceil(n/6) characters, with newline wrapping
every 120 characters for long solutions. Round-trips the reference's stored
oracle solutions (e.g. X_G14) exactly.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

BASE_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_$"
_DIGIT_INDEX = {c: i for i, c in enumerate(BASE_DIGITS)}


class SolutionCodec:
    def __init__(self, num_bits: int):
        self.num_bits = num_bits
        self.string_len = -(-num_bits // 6)  # ceil(num_bits / 6)

    def bits_to_str(self, bits: Union[Sequence[int], np.ndarray]) -> str:
        bits = np.asarray(bits).astype(bool).ravel()
        if bits.shape[0] != self.num_bits:
            raise ValueError(f"expected {self.num_bits} bits, got {bits.shape[0]}")
        x_int = int("".join("1" if b else "0" for b in bits), 2)
        digits = ""
        while True:
            x_int, rem = divmod(x_int, 64)
            digits = BASE_DIGITS[rem] + digits
            if x_int == 0:
                break
        if len(digits) > 120:
            digits = "\n".join(digits[i : i + 120] for i in range(0, len(digits), 120))
        if len(digits) > 64:
            digits = "\n" + digits
        return digits.zfill(self.string_len)

    def str_to_bits(self, s: str) -> np.ndarray:
        s = s.replace("\n", "").replace(" ", "")
        x_int = 0
        for c in s:
            x_int = x_int * 64 + _DIGIT_INDEX[c]
        out = np.zeros(self.num_bits, bool)
        binary = bin(x_int)[2:]
        if len(binary) > self.num_bits:
            raise ValueError("encoded value longer than num_bits")
        for i, c in enumerate(reversed(binary)):
            out[self.num_bits - 1 - i] = c == "1"
        return out
