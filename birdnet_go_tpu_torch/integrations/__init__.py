"""External integrations of the port: the notification service, its
inbox and its push-provider URLs. MQTT, BirdWeather, weather and the image
providers are not ported yet."""
