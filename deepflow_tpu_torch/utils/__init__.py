"""Wire codecs of the integrations and exporters: snappy, the
Prometheus WriteRequest, InfluxDB lines, MessagePack and Kafka."""
