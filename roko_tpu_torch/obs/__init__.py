"""Observability of the port's host side: the one-line event format
(``events``)."""
