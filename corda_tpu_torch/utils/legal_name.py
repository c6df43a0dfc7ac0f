"""Legal-name normalisation + validation for network registration.

Port of corda_tpu/utils/legal_name.py.

Reference: `LegalNameValidator.kt` (core/.../utilities/, rules list at
`legalNameRules`): names are the unique identifiers on the network, so
the permissioning server and the registering node both enforce rules
against encoding attacks and visual spoofing — NFKC normalisation,
banned characters/words, Latin-script restriction, capitalisation,
length and minimum-letter bounds.
"""

from __future__ import annotations

import re
import unicodedata

_WHITESPACE = re.compile(r"\s+")
_BANNED_CHARS = ',=$"\'\\'
_BANNED_WORDS = ("node", "server")
_MAX_LENGTH = 255


def normalise_legal_name(name: str) -> str:
    """Trim, collapse whitespace runs, NFKC-normalise
    (normaliseLegalName)."""
    return unicodedata.normalize("NFKC", _WHITESPACE.sub(" ", name.strip()))


def validate_legal_name(name: str) -> None:
    """Raise ValueError explaining the first violated rule
    (validateLegalName). Expects an already-normalised name, exactly
    like the reference's UnicodeNormalizationRule."""
    if name != normalise_legal_name(name):
        raise ValueError(
            "Legal name must be normalized. Please use "
            "normalise_legal_name before validation."
        )
    for ch in _BANNED_CHARS:
        if ch in name:
            raise ValueError(f"Character not allowed in legal names: {ch}")
    lowered = name.lower()
    for word in _BANNED_WORDS:
        if word in lowered:
            raise ValueError(f"Word not allowed in legal names: {word}")
    if len(name) > _MAX_LENGTH:
        raise ValueError(f"Legal name longer than {_MAX_LENGTH} characters.")
    for ch in name:
        if ch.isalpha() and not unicodedata.name(ch, "").startswith("LATIN"):
            raise ValueError(f"Forbidden character {ch!r} in {name!r}.")
    if name[:1] != name[:1].upper():
        raise ValueError("Legal name should be capitalized.")
    if sum(1 for ch in name if ch.isalpha()) < 2:
        raise ValueError(
            f"Illegal input legal name {name!r}. "
            "Legal name must have at least two letters"
        )
