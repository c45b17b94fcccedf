"""Op ABI: the libtool-ABI-string analogue for the port's ops.

A copy of `repro/core/abi.py`: a bundle built against the JAX package
names the same ABI strings, so the two must compute identical digests
(tests/test_torch_core.py pins it).

The paper's MPI support hinges on the MPICH ABI compatibility initiative:
implementations that share an ABI string are interchangeable at deployment
time without recompilation.  In a traced/JIT world the binary contract
becomes a *structural* one: two implementations of a logical op are
interchangeable iff

  1. they implement the same logical op name,
  2. they agree on the abstract signature (argument structure, dtypes and
     shape polymorphism expressed as a canonical signature string), and
  3. they share a semantic major version (minor versions are compatible,
     mirroring libtool's ``current:revision:age``).

`AbiString` encodes (1)-(3) into a printable string that can be compared the
way Shifter compares libtool strings before swapping libmpi.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Mapping, Sequence

__all__ = [
    "AbiString",
    "AbiError",
    "AbiIncompatibility",
    "signature_digest",
    "parse_abi",
]

_ABI_RE = re.compile(
    r"^(?P<name>[a-z][a-z0-9_.]*)/"
    r"(?P<major>\d+):(?P<minor>\d+)/"
    r"(?P<digest>[0-9a-f]{12})$"
)


class AbiError(ValueError):
    """Malformed ABI string."""


class AbiIncompatibility(RuntimeError):
    """Raised when a swap is attempted between incompatible ABIs.

    Shifter's behaviour on a libtool-string mismatch is to refuse the swap
    and keep the container's own library; `OpRegistry` mirrors that, using
    this exception (or a warning, in permissive mode) as the refusal signal.
    """

    def __init__(self, want: "AbiString", have: "AbiString", reason: str):
        self.want = want
        self.have = have
        self.reason = reason
        super().__init__(
            f"ABI mismatch for op '{want.name}': required {want} but "
            f"implementation provides {have} ({reason})"
        )


def signature_digest(signature: Mapping[str, Any] | Sequence[Any] | str) -> str:
    """Canonical 12-hex-digit digest of an op's abstract signature.

    The signature is whatever structured description the op author provides
    (argument names, rank constraints, dtype classes...).  It is canonicalised
    via repr of sorted items so dict ordering never changes the digest.
    """

    def _canon(obj: Any) -> str:
        if isinstance(obj, Mapping):
            inner = ",".join(f"{k}={_canon(obj[k])}" for k in sorted(obj))
            return "{" + inner + "}"
        if isinstance(obj, (list, tuple)):
            return "[" + ",".join(_canon(x) for x in obj) + "]"
        return repr(obj)

    blob = _canon(signature).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


@dataclasses.dataclass(frozen=True, order=True)
class AbiString:
    """``name/major:minor/digest`` — the comparable deployment contract."""

    name: str
    major: int
    minor: int
    digest: str

    def __post_init__(self) -> None:
        if not re.match(r"^[a-z][a-z0-9_.]*$", self.name):
            raise AbiError(f"invalid op name {self.name!r}")
        if self.major < 0 or self.minor < 0:
            raise AbiError("versions must be non-negative")
        if not re.match(r"^[0-9a-f]{12}$", self.digest):
            raise AbiError(f"invalid digest {self.digest!r}")

    # -- construction -----------------------------------------------------
    @classmethod
    def make(
        cls,
        name: str,
        signature: Mapping[str, Any] | Sequence[Any] | str,
        major: int = 1,
        minor: int = 0,
    ) -> "AbiString":
        return cls(name=name, major=major, minor=minor,
                   digest=signature_digest(signature))

    # -- comparison --------------------------------------------------------
    def compatible_with(self, other: "AbiString") -> bool:
        """True iff `other` may be substituted where `self` is required.

        Mirrors libtool semantics: same name, same signature digest, same
        major version; the provider's minor version must be >= the required
        minor (newer revisions keep old entry points).
        """
        return (
            self.name == other.name
            and self.digest == other.digest
            and self.major == other.major
            and other.minor >= self.minor
        )

    def why_incompatible(self, other: "AbiString") -> str | None:
        if self.name != other.name:
            return f"op name differs ({self.name} vs {other.name})"
        if self.digest != other.digest:
            return "signature digest differs"
        if self.major != other.major:
            return f"major version differs ({self.major} vs {other.major})"
        if other.minor < self.minor:
            return f"provider minor {other.minor} older than required {self.minor}"
        return None

    def __str__(self) -> str:  # the printable "libtool string"
        return f"{self.name}/{self.major}:{self.minor}/{self.digest}"


def parse_abi(text: str) -> AbiString:
    m = _ABI_RE.match(text.strip())
    if not m:
        raise AbiError(f"malformed ABI string: {text!r}")
    return AbiString(
        name=m.group("name"),
        major=int(m.group("major")),
        minor=int(m.group("minor")),
        digest=m.group("digest"),
    )
