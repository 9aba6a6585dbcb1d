"""Serving: the API layer, the HTTP transport and the server that joins them."""

from pilosa_tpu_torch.server.api import API, ApiError
from pilosa_tpu_torch.server.server import Server
