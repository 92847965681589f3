"""Images a second served over the untraced rest of a traced serving
window: the pace that the host's dispatch sets where it spreads too widely
between processes to hold ``serve_img_s`` end to end."""

from perfbench.readers import rest_img_s as read  # noqa: F401
