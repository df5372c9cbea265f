"""Typed exception hierarchy for the ChalametPIR framework.

Mirrors the reference's error enum (reference:
chalametpir_common/src/error.rs:8-50) so that every failure mode a
reference user relies on has a named equivalent here. The Vulkan-specific
variants map onto a single `AcceleratorError` family since the device
backend surfaces failures through JAX/XLA instead.
"""

from __future__ import annotations


class ChalametPIRError(Exception):
    """Base class for every error raised by this framework."""


# --- Accelerator backend (reference: error.rs Vulkan* variants) ----------


class AcceleratorError(ChalametPIRError):
    """A device (JAX/XLA) operation failed, or the platform is unsupported."""


# --- Matrix ---------------------------------------------------------------


class InvalidMatrixDimension(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("The number of rows and columns in the matrix must be non-zero.")


class IncompatibleDimensionForMatrixMultiplication(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("The matrix dimensions do not allow multiplication.")


class IncompatibleDimensionForMatrixAddition(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("The matrix dimensions do not allow addition.")


class InvalidNumberOfElementsInMatrix(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__('The matrix must have "rows * columns" elements.')


class IncompatibleDimensionForRowVectorTransposedMatrixMultiplication(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__(
            "The dimensions are incompatible for multiplication of a row vector and a transposed matrix."
        )


class InvalidDimensionForVector(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("A vector must have either one row or one column.")


class FailedToDeserializeMatrixFromBytes(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Matrix deserialization failed")


# --- Binary fuse filter ----------------------------------------------------


class EmptyKVDatabase(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Cannot encode empty key-value database.")


class ExhaustedAllAttemptsToBuildFilter(ChalametPIRError):
    def __init__(self, arity: int, max_attempts: int) -> None:
        self.arity = arity
        self.max_attempts = max_attempts
        super().__init__(
            f"Exhausted {max_attempts} attempts to build {arity}-wise XOR binary fuse filter."
        )


class RowNotDecodable(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Encoded KV database matrix's row cannot be decoded.")


class DecodedRowNotPrependedWithDigestOfKey(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Decoded row does not have the digest of the key prepended to it.")


class FailedToDeserializeFilterFromBytes(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Binary fuse filter deserialization failed")


# --- PIR protocol -----------------------------------------------------------


class KVDatabaseSizeTooLarge(ChalametPIRError):
    def __init__(self, msg: str | None = None) -> None:
        super().__init__(msg or "The key-value database is too large; it can have a maximum of 2^42 entries.")


class InvalidHintMatrix(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Unexpected number of rows in the hint matrix.")


class PendingQueryExistsForKey(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("A pending query for this key was found in the internal client state.")


class PendingQueryDoesNotExistForKey(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("No pending query for this key exists in the internal client state.")


class ArithmeticOverflowAddingQueryIndicator(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__(
            "Encountered arithmetic overflow while adding the query indicator to the query vector 'b'."
        )


class UnsupportedArityForBinaryFuseFilter(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Binary Fuse Filter supports arity of either 3 or 4.")


class InvalidResponseVector(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__("Unexpected dimension of the response vector.")


class ImpossibleEncodedDBMatrixElementBitLength(ChalametPIRError):
    def __init__(self) -> None:
        super().__init__(
            "Encoded database matrix's element bit length must be within [4, 14] bits."
        )
