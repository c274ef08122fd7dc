"""Proof options and protocol parameters.

Mirrors the knobs the reference passes to winterfell
(src/prove.rs:963-972: FieldExtension::None, fri folding 2, remainder max
degree 1, Linear batching) plus zk-lisp's ProverOptions
(zk-lisp-proof/src/lib.rs:38-69) and the partition policy
(src/utils.rs:394-409).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ProofOptions:
    num_queries: int = 32
    blowup: int = 16
    grinding_factor: int = 0
    field_extension: int = 1          # 1 = None, 2 = Quadratic
    fri_folding_factor: int = 2
    fri_remainder_max_degree: int = 1
    num_partitions: int = 1
    hash_rate: int = 8
    # Boundary-assertion batching for the constraint composition:
    #   "grouped"       — one composition coefficient per periodic
    #                     (column, value, stride) class (TPU-native
    #                     default; PARITY.md deviation 1)
    #   "per_assertion" — one coefficient per assertion with a single
    #                     (x - g^step) divisor each, exactly winterfell's
    #                     construction (the reference emits only
    #                     Assertion::single — vm/air/schedule.rs:63-136).
    #                     O(unique_steps * lde_size) divisor work: use
    #                     for winterfell parity, not for throughput.
    assertion_batching: str = "grouped"

    @property
    def per_assertion(self) -> bool:
        return self.assertion_batching == "per_assertion"

    def with_partitions(self, num_partitions: int,
                        hash_rate: int) -> "ProofOptions":
        return replace(self, num_partitions=num_partitions,
                       hash_rate=hash_rate)

    # -- FRI geometry ------------------------------------------------------

    def fri_max_remainder_size(self) -> int:
        return (self.fri_remainder_max_degree + 1) * self.blowup

    def num_fri_layers(self, lde_domain_size: int) -> int:
        layers = 0
        size = lde_domain_size
        max_rem = self.fri_max_remainder_size()
        while size > max_rem:
            size //= self.fri_folding_factor
            layers += 1
        return layers

    def partition_size(self, num_columns: int) -> int:
        """Row-hash chunk size (winterfell PartitionOptions semantics)."""
        if self.num_partitions <= 1:
            return num_columns
        return max(-(-num_columns // self.num_partitions), self.hash_rate)

    def to_elements(self) -> list:
        """Options part of the FS context seed."""
        return [
            self.num_queries,
            self.blowup,
            self.grinding_factor,
            self.field_extension,
            self.fri_folding_factor,
            self.fri_remainder_max_degree,
        ]


def winterfell_compat_env() -> bool:
    """ZKL_WINTERFELL_COMPAT env toggle (empty string disables)."""
    import os

    return bool(os.environ.get("ZKL_WINTERFELL_COMPAT"))


@dataclass(frozen=True)
class ProverOptions:
    """Backend-agnostic prover knobs (zk-lisp-proof ProverOptions)."""
    queries: int = 32
    blowup: int = 16
    grind: int = 0
    min_security_bits: int = 64
    max_segment_rows: Optional[int] = None
    max_concurrent_segments: Optional[int] = None
    winterfell_compat: bool = False

    def to_proof_options(self) -> ProofOptions:
        compat = self.winterfell_compat or winterfell_compat_env()
        return ProofOptions(
            num_queries=self.queries, blowup=self.blowup,
            grinding_factor=self.grind,
            assertion_batching="per_assertion" if compat else "grouped")


def select_partitions_for_trace(trace_width: int,
                                trace_length: int) -> tuple:
    """utils.rs select_partitions_for_trace."""
    hash_rate = 8 if trace_width <= 32 else 16
    if trace_length >= (1 << 20):
        num = 16
    elif trace_length >= (1 << 18):
        num = 8
    elif trace_length >= (1 << 16):
        num = 4
    elif trace_length >= (1 << 14):
        num = 2
    else:
        num = 1
    return num, hash_rate


def estimate_conjectured_security_bits(opts: ProofOptions) -> int:
    """prove.rs estimate_conjectured_security_bits."""
    base_field_bits = 128
    field_security = base_field_bits * opts.field_extension
    security_per_query = opts.blowup.bit_length() - 1
    query_security = security_per_query * opts.num_queries
    if query_security >= 80:
        query_security += opts.grinding_factor
    collision_resistance = 128
    return min(min(field_security, query_security) - 1,
               collision_resistance)
