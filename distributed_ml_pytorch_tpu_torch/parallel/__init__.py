"""Parallel training strategies of the port: the DownPour parameter server
(``async_ps``)."""
