"""The system under test: ``seal_tpu_torch``, driven through its batch
evaluator.

This is the one module of the benchmark that imports the program.  It
builds a context from a configuration file, wraps the benchmark's input
tensors in the program's objects, one set of requests and keys for each
client, and hands back each call's output as plain tensors and metadata
for the comparison.
"""

from __future__ import annotations

from typing import Dict

from seal_tpu_torch import (EncryptionParameters, GaloisKeys, Modulus, Plaintext, RelinKeys, SchemeType,
                            SealContext, SecurityLevel)
from seal_tpu_torch.parallel.batch import BatchEvaluator, CiphertextBatch

from .inputs import Inputs
from .traffic import key_elements, rotations

SCHEMES = {"ckks": SchemeType.CKKS, "bfv": SchemeType.BFV, "bgv": SchemeType.BGV}
LEVELS = {"none": SecurityLevel.NONE, "tc128": SecurityLevel.TC128, "tc192": SecurityLevel.TC192,
          "tc256": SecurityLevel.TC256}


def build_context(config: dict, device) -> SealContext:
    parms = EncryptionParameters(SCHEMES[config["scheme"]])
    parms.set_poly_modulus_degree(int(config["poly_modulus_degree"]))
    parms.set_coeff_modulus([Modulus(int(p)) for p in config["coeff_modulus"] + [config["special_prime"]]])
    if config.get("plain_modulus"):
        parms.set_plain_modulus(int(config["plain_modulus"]))
    return SealContext(parms, True, LEVELS[config["security_level"]], device=device)


class System:
    """The program's context and batch evaluator, the shared plaintexts, and
    each client's requests and keys, resident on the device."""

    def __init__(self, config: dict, mix: dict, inputs: Inputs, device):
        self.config, self.mix, self.inputs = config, mix, inputs
        self.n = int(config["poly_modulus_degree"])
        self.context = build_context(config, device)
        self.evaluator = BatchEvaluator(self.context)
        self.ntt_form = config["scheme"] != "bfv"
        self.scale = float(config.get("scale", 1.0))
        rotations(mix, self.n)
        self.shared = {name: self._plaintext(name) for name in mix["shared"]}
        self.clients = [self._client(c) for c in range(mix["clients"])]

    def _plaintext(self, name: str) -> Plaintext:
        p = Plaintext()
        p.parms_id = self.context.first_parms_id
        p.scale = self.scale
        p.rns_data = self.inputs.plaintext(name)
        return p

    def _keys(self, name: str, kind: str, client: int):
        elts = key_elements(kind, self.n)
        data = self.inputs.key_set(name, client, len(elts))
        holder = RelinKeys() if kind == "relin_keys" else GaloisKeys()
        holder.parms_id = self.context.key_parms_id
        holder.keys = [None] * (1 if kind == "relin_keys" else self.n)
        for j, e in enumerate(elts):
            holder.keys[0 if e is None else e >> 1] = {"c0": data[j, 0], "c1": data[j, 1], "seeds": None}
        return holder

    def _client(self, client: int) -> Dict[str, object]:
        """Client ``client``'s registers: a batch of ``mix['batch']``
        requests for each request input, and its key sets."""
        out = {}
        for name in self.mix["requests"]:
            data = self.inputs.ciphertexts(name, client, int(self.mix["batch"]))
            out[name] = CiphertextBatch(data, self.context.first_parms_id, self.ntt_form, self.scale)
        for name, kind in self.mix["client_keys"].items():
            out[name] = self._keys(name, kind, client)
        return out

    def registers(self, call: int) -> Dict[str, object]:
        """The inputs of call ``call``: its client's and the shared ones."""
        return {**self.clients[call % len(self.clients)], **self.shared}

    @staticmethod
    def output(out: CiphertextBatch) -> dict:
        """A call's output as (B, size, k, n) words and metadata."""
        return {"data": out.data, "ntt_form": bool(out.is_ntt_form), "scale": float(out.scale)}
