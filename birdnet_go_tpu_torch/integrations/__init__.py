"""External integrations of the port: the notification service, its inbox
and its push-provider URLs, the image providers, MQTT (with Home
Assistant discovery), BirdWeather, the weather providers and eBird."""
