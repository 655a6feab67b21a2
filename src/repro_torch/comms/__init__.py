"""The port's communication layer: the wire codec, the socket transport,
peers, leases and the aggregation server."""
