"""Async checkpointing with commit-ordered restore (port of
``repro/checkpoint``)."""
from .checkpointer import Checkpointer
