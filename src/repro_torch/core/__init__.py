"""The paper's losses (virtual teacher, Eq. 7-8)."""
