"""HTTP serving surface of the port: settings-driven model service (``service.py``,
no aiohttp) behind an aiohttp app (``server.py``)."""
