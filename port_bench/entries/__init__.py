"""Entries: each module drives one entry point of the program (`Entry`)
and works out its reference (`Entry.reference`)."""
