"""The QoS pieces the EC degraded-read path uses: singleflight leases
and the first-k-wins gather over the shared attempt pool."""
